"""Minimal structured logger (stdlib only, consistent format) plus the
per-key rate limiter the observability event log mirrors through."""
from __future__ import annotations

import logging
import sys
import time

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"repro_torch.{name}")


class RateLimiter:
    """Per-key minimum-interval limiter with suppressed-count accounting.

    ``allow(key)`` returns ``(ok, suppressed)``: ``ok`` is True at most
    once per ``min_interval_s`` per key, and ``suppressed`` reports how
    many calls were dropped since the last allowed one — so a
    human-readable mirror of a high-rate event stream (a mass join, a
    resize storm) stays honest about what it elided.  State is one
    ``(last_ts, dropped)`` pair per distinct key: bounded by the event
    vocabulary, not the event rate.
    """

    def __init__(self, min_interval_s: float = 1.0) -> None:
        self.min_interval_s = min_interval_s
        self._state: dict[str, list] = {}  # key -> [last_allowed, dropped]

    def allow(self, key: str, now: float | None = None) -> tuple[bool, int]:
        now = time.monotonic() if now is None else now
        st = self._state.get(key)
        if st is None:
            self._state[key] = [now, 0]
            return True, 0
        if now - st[0] >= self.min_interval_s:
            suppressed, st[0], st[1] = st[1], now, 0
            return True, suppressed
        st[1] += 1
        return False, 0
