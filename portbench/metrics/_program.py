"""What the readers of the program's own spans and counters share.

The program keeps its record in ``repro_torch.obs`` bundles (a bounded
span ring, a metrics registry), which ``repro_torch.obs.live()`` lists
in order of creation.  A reader takes the newest bundle that holds what
it reads, and from the span ring only what was recorded before the
benchmark's ``portbench.epoch`` marker (set-up and the window, not the
profiled sub-window).  A program without ``live()``, or whose record
holds no such span or counter, gives None: the metric is left out.
"""
from __future__ import annotations

import statistics

EPOCH = "portbench.epoch"


def bundles() -> list:
    """The program's live observability bundles, newest first."""
    try:
        from repro_torch.obs import live
    except ImportError:
        return []
    return list(reversed(live()))


def spans(probe: str) -> list[dict] | None:
    """The newest bundle's ring that holds a span named ``probe``, up to
    the epoch marker (its whole ring without one)."""
    for b in bundles():
        evs = b.trace.spans()
        if any(e["name"] == probe for e in evs):
            cut = next((i for i, e in enumerate(evs)
                        if e["name"] == EPOCH), len(evs))
            return evs[:cut]
    return None


def median_ms(name: str) -> float | None:
    """The median duration of the spans named ``name``, ms."""
    evs = spans(name)
    if evs is None:
        return None
    return statistics.median(e["dur_s"] for e in evs
                             if e["name"] == name) * 1e3


def decode_ticks(evs: list[dict]) -> list[dict]:
    """The ``decode.issue`` spans of decode ticks (a child of a ``decode``
    span, not of the async plane's ``decode_dispatch``)."""
    ticks = {e["id"] for e in evs if e["name"] == "decode"}
    return [e for e in evs
            if e["name"] == "decode.issue" and e["parent"] in ticks]


def tick_child_ms(name: str) -> float | None:
    """The median of ``name`` (a child of ``decode``) over decode ticks,
    ms."""
    evs = spans(name)
    if evs is None:
        return None
    ticks = {e["id"] for e in evs if e["name"] == "decode"}
    durs = [e["dur_s"] for e in evs
            if e["name"] == name and e["parent"] in ticks]
    return statistics.median(durs) * 1e3 if durs else None


def layer_issue_ms(name: str) -> float | None:
    """The median over decode ticks of the tick's summed ``name`` spans
    (children of its ``decode.issue``), ms."""
    evs = spans(name)
    if evs is None:
        return None
    per = {e["id"]: 0.0 for e in decode_ticks(evs)}
    for e in evs:
        if e["name"] == name and e["parent"] in per:
            per[e["parent"]] += e["dur_s"]
    return statistics.median(per.values()) * 1e3 if per else None


def counters(*names: str) -> list[float] | None:
    """The values of registry counters ``names`` in the newest bundle
    whose registry holds the first of them, non-zero."""
    for b in bundles():
        reg = b.registry
        if names[0] in reg and reg.counter(names[0]).value:
            return [reg.counter(n).value if n in reg else 0
                    for n in names]
    return None


def histogram_median(name: str) -> float | None:
    """The median of the registry histogram ``name`` in the newest bundle
    where it holds a sample."""
    for b in bundles():
        reg = b.registry
        if name in reg and reg.histogram(name).count:
            return reg.histogram(name).quantile(0.5)
    return None
