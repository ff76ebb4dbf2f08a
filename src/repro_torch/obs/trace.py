"""Spans over the runtime's work, with parent links, Chrome trace-event
export and ranges in a running ``torch.profiler`` trace.

The streaming hop is a pipeline (pack -> dispatch -> device -> detector)
and the LM tick a stack of layers; either is judged by *where inside* the
time goes, not by one aggregate number.  ``Tracer`` records lightweight
spans into a bounded ring (O(1) memory over unbounded uptime, same
discipline as the metrics registry) and exports them as Chrome
trace-event JSON: load the file at ``ui.perfetto.dev`` (or
``chrome://tracing``) to see every hop's phase breakdown on a timeline.

Recording:

* ``with tracer.span("push"):`` the context-manager form.  While a
  ``torch.profiler`` profile records, the span also opens a
  ``record_function`` range of its name, so it sits in the device trace,
  on the profiler's clock, nested like the ring's spans; with no profile
  recording this costs one check.  ``span.phases(names)`` stamps
  back-to-back children of an open span (one clock read a phase, one
  ``add_batch`` at the end), as ingest and a stream's join do.
* ``tracer.add("pack", t0, dur)`` / ``add_batch`` the raw forms for the
  hop hot path, where the caller already holds ``time.perf_counter()``
  stamps for the metrics phases.  They are recorded after the fact, so
  they are ring-only: a profile sees the ranges of the spans around them.
* ``repro_torch.obs.span(name)`` for code that holds no tracer (the model
  stack, the MoE dispatch): it records into the tracer whose span is the
  innermost one open on this thread, and is a no-op when none is open or
  that tracer is disabled.

Every span gets an id and its parent's: the innermost span of the same
tracer open on this thread (a per-thread stack of open spans), or the
parent ``add`` / ``add_batch`` are given.  Timestamps are monotonic
(``perf_counter``) relative to the tracer's epoch, exported in
microseconds as the trace-event spec requires.  Consecutive phases share
boundary stamps, so the exported spans tile their parent exactly.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from time import perf_counter as _clock

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

#: span ids, unique in the process (``next`` on a count is atomic)
_ids = itertools.count(1)
#: each thread's stack of open spans: ``[tracer, id]`` entries, the id
#: None for a disabled tracer's span
_local = threading.local()
_NULL = contextlib.nullcontext()


def _open_id(tracer) -> int | None:
    """The id of ``tracer``'s innermost span open on this thread."""
    for tr, sid in reversed(getattr(_local, "stack", ())):
        if tr is tracer:
            return sid
    return None


def span(name: str, **args):
    """A span in the tracer of the innermost span open on this thread; a
    shared no-op context when none is open or that tracer is disabled."""
    st = getattr(_local, "stack", None)
    if not st or st[-1][1] is None:
        return _NULL
    return _Span(st[-1][0], name, args)


class _NoPhases:
    """``phases`` of a disabled span: every call a no-op."""

    __slots__ = ()

    def mark(self) -> None:
        pass

    def record(self) -> None:
        pass


_NO_PHASES = _NoPhases()


class Phases:
    """Back-to-back children of an open span: ``mark()`` ends the running
    phase (one clock read), ``record()`` adds every ended phase under the
    span with one ``add_batch``.  The first phase starts at the span's own
    start stamp, so the phases tile the span up to the last mark."""

    __slots__ = ("_span", "_names", "_t")

    def __init__(self, sp: "_Span", names: tuple[str, ...]) -> None:
        self._span, self._names, self._t = sp, names, [sp.t0]

    def mark(self) -> None:
        self._t.append(_clock())

    def record(self) -> None:
        t = self._t
        self._span.tracer.add_batch(
            ((n, a, b - a, {}) for n, a, b in zip(self._names, t, t[1:])),
            parent=self._span.id)


class _Span:
    """One open span (``Tracer.span``, ``obs.span``): ``id`` and ``t0``
    (its ``perf_counter`` start) are set on entry."""

    __slots__ = ("tracer", "name", "args", "id", "parent", "t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict) -> None:
        self.tracer, self.name, self.args = tracer, name, args
        self.id = None
        self._range = None

    def __enter__(self) -> "_Span":
        tr = self.tracer
        st = getattr(_local, "stack", None)
        if st is None:
            st = _local.stack = []
        if not tr.enabled:
            st.append((tr, None))
            return self
        self.parent = (st[-1][1] if st and st[-1][0] is tr
                       else _open_id(tr))
        self.id = next(_ids)
        st.append((tr, self.id))
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _clock()
        _local.stack.pop()
        if self.id is None:
            return
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.tracer._append(self.name, self.t0, t1 - self.t0, self.args,
                            self.id, self.parent)

    def phases(self, names: tuple[str, ...]):
        """Stamps for the back-to-back children ``names`` of this span
        (a no-op object when the tracer is disabled)."""
        return _NO_PHASES if self.id is None else Phases(self, names)


class Tracer:
    """Bounded span recorder; disabled mode is a near-free no-op."""

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 process_name: str = "repro") -> None:
        self.enabled = enabled
        self.process_name = process_name
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._epoch = time.perf_counter()
        self.dropped = 0  # spans evicted from the ring (uptime > capacity)

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def __len__(self) -> int:
        return len(self._events)

    # -- recording -----------------------------------------------------------

    def _append(self, name, t0, dur_s, args, sid, parent) -> None:
        # empty args stored as None: a ring entry of atomic fields only
        # is untracked by the cyclic collector, which then never walks it
        ev = self._events
        if len(ev) == ev.maxlen:
            self.dropped += 1
        ev.append((name, t0 - self._epoch, dur_s, threading.get_ident(),
                   args or None, sid, parent))

    def add(self, name: str, t0: float, dur_s: float, *,
            parent: int | None = None, **args) -> int | None:
        """Record a completed span: ``t0`` is a ``time.perf_counter()``
        stamp, ``dur_s`` its duration, its parent ``parent`` or else the
        innermost span of this tracer open on this thread.  One deque
        append -> the span's id (None when disabled)."""
        if not self.enabled:
            return None
        sid = next(_ids)
        self._append(name, t0, dur_s, args, sid,
                     _open_id(self) if parent is None else parent)
        return sid

    def add_batch(self, spans, parent: int | None = None) -> None:
        """Record several completed spans in one call, each a child of
        ``parent`` (default: the innermost span of this tracer open on this
        thread).

        The hop hot path stamps every phase with consecutive
        ``perf_counter`` reads and hands them all over at once — one
        python call per hop instead of one per phase.  ``spans`` is an
        iterable of ``(name, t0, dur_s, args_dict)`` tuples.
        """
        if not self.enabled:
            return
        ev = self._events
        epoch = self._epoch
        tid = threading.get_ident()
        maxlen = ev.maxlen
        if parent is None:
            parent = _open_id(self)
        for name, t0, dur_s, args in spans:
            if len(ev) == maxlen:
                self.dropped += 1
            ev.append((name, t0 - epoch, dur_s, tid, args or None,
                       next(_ids), parent))

    def span(self, name: str, **args) -> _Span:
        """Context-managed span (body exceptions still close it); entered,
        it is the parent of what this thread records inside it, and while
        a ``torch.profiler`` profile records, a range of the same name."""
        return _Span(self, name, args)

    def reset(self) -> None:
        self._events.clear()
        self.dropped = 0

    # -- reporting -----------------------------------------------------------

    def spans(self, name: str | None = None) -> list[dict]:
        """Retained spans as dicts (seconds, tracer-epoch-relative), in
        the order recorded (a context-managed span after its children),
        each with its ``id`` and its ``parent``'s (None at the top)."""
        return [
            {"name": n, "t0": t0, "dur_s": dur, "tid": tid,
             "args": args or {}, "id": sid, "parent": parent}
            for n, t0, dur, tid, args, sid, parent in self._events
            if name is None or n == name
        ]

    def export_chrome(self, path=None, last: int | None = None):
        """Chrome trace-event JSON: a list when ``path`` is None, else
        written to ``path`` (``{"traceEvents": [...]}`` object form) and
        the event count returned.  ``last`` keeps only the trailing N
        spans — bench artifacts stay small without truncating the ring.

        Spans export as ``ph: "X"`` complete events (microsecond ``ts`` +
        ``dur``), which Perfetto nests by containment per thread.
        """
        events = list(self._events)
        if last is not None:
            events = events[-last:]
        tids = {}
        out = []
        for name, t0, dur, tid, args, _, _ in events:
            tids.setdefault(tid, len(tids))
            ev = {
                "name": name,
                "ph": "X",
                "ts": t0 * 1e6,
                "dur": dur * 1e6,
                "pid": 0,
                "tid": tids[tid],
            }
            if args:
                ev["args"] = args
            out.append(ev)
        meta = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": self.process_name}},
        ]
        if path is None:
            return meta + out
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + out, "displayTimeUnit": "ms"},
                      f)
            f.write("\n")
        return len(out)


def _dur(e: dict) -> float:
    return e["dur"] if "dur" in e else e["dur_s"]


def _start(e: dict) -> float:
    return e["ts"] if "dur" in e else e["t0"]


def _intervals(events: list[dict], names) -> list[tuple[float, float]]:
    """(start, end) of every span named in ``names``, in input units
    (Chrome events: microseconds; ``Tracer.spans()`` dicts: seconds)."""
    return [
        (_start(e), _start(e) + _dur(e))
        for e in events
        if e["name"] in names and ("dur" in e or "dur_s" in e)
    ]


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge intervals into a disjoint sorted union."""
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _measure(iv: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def _intersect(xs: list[tuple[float, float]],
               ys: list[tuple[float, float]]) -> float:
    """Total overlap between two disjoint sorted interval unions."""
    tot, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def coverage(events: list[dict], parent: str = "hop",
             phases: tuple[str, ...] = ("pack", "dispatch", "device",
                                        "detector", "push_fold"),
             mode: str = "tile") -> float:
    """Fraction of ``parent`` span wall time covered by phase spans.

    Operates on exported Chrome events (or ``Tracer.spans()`` dicts with
    ``dur_s``).  ``mode="tile"`` (the synchronous invariant) ratios
    summed durations: the hop phases are stamped back-to-back, so
    anything under the 0.95 acceptance floor means a phase went missing
    from the instrumentation — but under the async plane it double
    counts, because hop N+1's pack/dispatch legitimately overlap hop N's
    device span (the ratio can exceed 1.0).  ``mode="overlap"`` is the
    overlap-aware invariant: the measure of the *union* of phase
    intervals clipped to the union of parent intervals, over the parent
    union's measure — overlap never double counts and a missing phase
    still drops it below the floor.
    """
    if mode == "tile":
        tot = sum(_dur(e) for e in events if e["name"] == parent)
        cov = sum(_dur(e) for e in events if e["name"] in phases)
        return cov / tot if tot else 0.0
    assert mode == "overlap", mode
    par = _union(_intervals(events, (parent,)))
    phs = _union(_intervals(events, phases))
    tot = _measure(par)
    return _intersect(phs, par) / tot if tot else 0.0


def overlap_stats(events: list[dict], busy: tuple[str, ...] = ("device",),
                  hidden_under: tuple[str, ...] = ("pack", "detector"),
                  ) -> dict[str, float]:
    """Union-interval account of how much host work hid under device
    compute — the async plane's acceptance measure.

    ``busy`` spans (device execution, including queue wait at retire)
    merge into one busy union; every ``hidden_under`` span's overlap
    with that union counts as hidden.  Returns totals in the input's
    time unit (seconds for ``Tracer.spans()`` dicts, microseconds for
    exported Chrome events) plus the unit-free ``hidden_frac`` and
    ``utilization`` (busy fraction of the overall span extent).
    """
    busy_u = _union(_intervals(events, busy))
    host_iv = _intervals(events, hidden_under)
    host_u = _union(host_iv)
    host_total = _measure(host_u)
    hidden = _intersect(host_u, busy_u)
    everything = _union(_intervals(
        events, {e["name"] for e in events if "dur" in e or "dur_s" in e}
    ))
    extent = (everything[-1][1] - everything[0][0]) if everything else 0.0
    busy_total = _measure(busy_u)
    return {
        "busy_total": busy_total,
        "host_total": host_total,
        "hidden": hidden,
        "hidden_frac": hidden / host_total if host_total else 0.0,
        "extent": extent,
        "utilization": busy_total / extent if extent else 0.0,
    }
