"""repro_torch.obs — runtime-wide observability: metrics, traces, events.

The paper's headline results are *cost-accounting* results (Table I
splits every inference into MAC/SA/SRAM/controller energy; the pooling
write-back claim is a latency split), and the ROADMAP's next steps
(async ingest/compute overlap, open-loop SLO harness) are judged by
per-phase hop timing at p99/p999.  This package is the measurement
substrate for all of that, built for the always-on deployment the paper
targets: **every instrument is O(1) memory over unbounded uptime.**

Three planes, one bundle:

* ``MetricsRegistry`` (registry.py) — counters, gauges, fixed-bucket
  log-linear ``Histogram``\\ s (p50..p999 with bounded relative error)
  and exact-while-short ``Reservoir``\\ s, with strict-JSON snapshots.
* ``Tracer`` (trace.py) — lightweight spans with parent links over the
  hop pipeline, ingest, joins and the LM tick down to its layers,
  exported as Chrome trace-event JSON (open in Perfetto); while a
  ``torch.profiler`` profile records, every context-managed span is also
  a ``record_function`` range there, beside the CUDA kernels.
  ``span(name)`` records from code that holds no tracer (the model stack,
  the MoE dispatch) into the tracer of the innermost open span.
* ``EventLog`` (events.py) — JSONL lifecycle records (join / close /
  resize / rebalance / detection / mass-join) with monotonic
  timestamps, mirrored into ``utils.logging`` behind a per-kind rate
  limit.

``Observability`` glues them together; ``StreamScheduler`` and
``serve.Engine`` accept one via ``obs=`` (and build an enabled default
otherwise, so instrumentation is always on and always bounded).
``live()`` lists the bundles alive in the process, in order of creation
(weak references), for an exporter or a benchmark's reader that holds no
handle on the runtime.

    >>> from repro_torch.obs import Observability
    >>> obs = Observability.create()
    >>> with obs.trace.span("pack"):
    ...     obs.registry.counter("hops").inc()
    >>> _ = obs.events.emit("join", sid=0)
    >>> obs.registry.snapshot()["hops"]
    1
"""
from __future__ import annotations

import dataclasses
import weakref

from repro_torch.obs.events import EventLog
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
)
from repro_torch.obs.trace import Tracer, coverage, overlap_stats, span

#: weak references to every bundle made, in order (dead ones pruned)
_LIVE: list[weakref.ref] = []


def live() -> list["Observability"]:
    """The bundles alive in the process, oldest first."""
    return [o for o in (r() for r in _LIVE) if o is not None]


@dataclasses.dataclass
class Observability:
    """One runtime's observability surface: registry + tracer + events."""

    registry: MetricsRegistry
    trace: Tracer
    events: EventLog

    def __post_init__(self) -> None:
        _LIVE[:] = [r for r in _LIVE if r() is not None]
        _LIVE.append(weakref.ref(self))

    @classmethod
    def create(cls, *, enabled: bool = True, trace_capacity: int = 65536,
               event_path=None, event_capacity: int = 4096,
               mirror_events: bool = True) -> "Observability":
        """Build a bundle; ``enabled=False`` keeps the registry (metrics
        stay cheap and bounded) but turns spans into no-ops, stops event
        mirroring and stops the LM engine's expert tally — the knob the
        overhead microbench compares against."""
        return cls(
            registry=MetricsRegistry(),
            trace=Tracer(capacity=trace_capacity, enabled=enabled),
            events=EventLog(path=event_path, capacity=event_capacity,
                            mirror=enabled and mirror_events),
        )


__all__ = [
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "Reservoir",
    "Tracer",
    "coverage",
    "live",
    "overlap_stats",
    "span",
]
