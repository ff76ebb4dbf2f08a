"""Structured lifecycle event log: JSONL records, bounded memory.

Latency histograms answer "how fast"; the event log answers "what
happened": every join / close / resize / rebalance / detection /
mass-join lands here as one flat JSON record with a monotonic timestamp
and a process-wide sequence number, so a saturating pool or a rebalance
storm can be reconstructed after the fact without scraping free-text
logs.

Three sinks, independently bounded:

* an in-memory ring (``tail()``) — always on, O(1) memory;
* an optional JSONL file — **every** event is written (the bench
  acceptance requires the artifact to be complete), line-buffered
  append;
* the ``utils.logging`` logger — human-readable mirror, rate-limited
  *per event kind* (``utils.logging.RateLimiter``) so a 1k-stream mass
  join emits 1k JSONL records but only one INFO line (with the
  suppressed count folded into the next line that does get through).
"""
from __future__ import annotations

import collections
import json
import time

from repro_torch.utils.logging import RateLimiter, get_logger

log = get_logger("obs.events")


class EventLog:
    """Append-only structured event sink with a bounded in-memory tail."""

    def __init__(self, path=None, capacity: int = 4096,
                 mirror_interval_s: float = 1.0, mirror: bool = True,
                 mode: str = "a") -> None:
        """``mode="a"`` (default) appends across restarts — the service
        shape; bench artifacts pass ``mode="w"`` so each run's JSONL is
        exactly that run."""
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._t0 = time.monotonic()
        self._file = (open(path, mode, buffering=1)
                      if path is not None else None)
        self.path = path
        self._mirror = mirror
        self._limiter = RateLimiter(mirror_interval_s)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def seq(self) -> int:
        """Events emitted so far (>= ``len`` once the ring wraps)."""
        return self._seq

    def emit(self, event: str, **fields) -> dict:
        """Record one event; returns the record.  ``ts`` is monotonic
        seconds since the log was created — immune to wall-clock steps,
        and directly comparable with the tracer's span stamps."""
        rec = {
            "ts": time.monotonic() - self._t0,
            "seq": self._seq,
            "event": event,
        }
        rec.update(fields)
        self._seq += 1
        self._ring.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
        if self._mirror:
            ok, suppressed = self._limiter.allow(event)
            if ok:
                extra = f" (+{suppressed} suppressed)" if suppressed else ""
                log.info("%s %s%s", event,
                         " ".join(f"{k}={v}" for k, v in fields.items()),
                         extra)
        return rec

    def tail(self, n: int | None = None) -> list[dict]:
        """The most recent ``n`` retained events (all of them by default)."""
        events = list(self._ring)
        return events if n is None else events[-n:]

    def counts(self) -> dict[str, int]:
        """Retained-tail event-kind histogram (diagnostics, tests)."""
        out: dict[str, int] = {}
        for rec in self._ring:
            out[rec["event"]] = out.get(rec["event"], 0) + 1
        return out

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
