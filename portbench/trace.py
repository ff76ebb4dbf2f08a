"""A short profiled sub-window: device busy time, kernels by name, and the
device's idle gaps named by the host span open while they lasted.

``profile(step, n, host_spans)`` runs ``step()`` ``n`` times under
``torch.profiler`` (CPU and CUDA activity), writes the chrome trace to a
file under ``TMPDIR`` (deleted once read) and reduces it:

* device activity: events of the categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``; ``busy_s`` is the union of their intervals inside
  the window, ``window_s`` the window from the first step's start to the
  last step's end (the benchmark's ``portbench.step`` ranges);
* each idle gap of the device inside the window is named by the
  innermost host span that holds its midpoint: the program's own spans
  and the benchmark's, given on ``time.perf_counter``'s clock and moved
  onto the trace's clock by a marker range recorded at a known stamp.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160
STEP = "portbench.step"
SYNC = "portbench.sync"


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that ``busy`` (merged) does not cover."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def innermost(spans, t: float) -> str:
    """The name of the shortest span that holds ``t`` (``"outside"``
    when none does); ``spans`` are (start, end, name)."""
    best, name = None, "outside"
    for s, e, n in spans:
        if s <= t <= e and (best is None or e - s < best):
            best, name = e - s, n
    return name


def reduce_trace(events: list[dict], host_spans, offset_us: float,
                 top: int = 10) -> dict:
    """The summary of one profiled window (times in seconds).

    ``events`` are chrome-trace events; ``host_spans`` (start, end, name)
    on the host's ``perf_counter`` clock in seconds; ``offset_us`` maps
    that clock onto the trace's: ``ts = t * 1e6 + offset_us``."""
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == STEP
             and e.get("cat") == "user_annotation"]
    if not steps:
        raise RuntimeError("the profiled window holds no step range")
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    intervals = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev]
    busy = clip(union(intervals), lo, hi)
    busy_us = sum(e - s for s, e in busy)
    by_name: dict[str, list[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for e in dev:
        if lo <= e["ts"] <= hi:
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += e.get("dur", 0) * 1e-6
    spans = [(s * 1e6 + offset_us, e * 1e6 + offset_us, n)
             for s, e, n in host_spans]
    spans.sort()
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = collections.defaultdict(float)
    for s, e in gaps(busy, lo, hi):
        mid = (s + e) / 2
        k = bisect.bisect_right(starts, mid)
        near = spans[max(0, k - 64):k]     # spans starting before mid
        idle[innermost(near, mid)] += (e - s) * 1e-6
    kernels = [e for e in dev if e.get("cat") == "kernel"
               and lo <= e["ts"] <= hi]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "steps": len(steps),
        "kernel_count": len(kernels),
        "by_name": {n: (int(c), t) for n, (c, t) in by_name.items()},
        "device_ops": sorted(([n[:NAME_CHARS], t]
                              for n, (_, t) in by_name.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n, t] for n, t in idle.items()),
                            key=lambda r: -r[1])[:top],
    }


def profile(step, n: int, host_spans) -> dict:
    """Run ``step()`` ``n`` times under the profiler and reduce the trace.
    ``host_spans()`` is called after the window and returns the host
    spans (start, end, name) on the ``perf_counter`` clock."""
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t_a = time.perf_counter()
        with record_function(SYNC):
            pass
        t_b = time.perf_counter()
        for _ in range(n):
            with record_function(STEP):
                step()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    marks = [e for e in events if e.get("name") == SYNC
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the profiled window holds no sync marker")
    offset_us = marks[0]["ts"] - (t_a + t_b) / 2 * 1e6
    return reduce_trace(events, host_spans(), offset_us)
