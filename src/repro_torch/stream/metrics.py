"""Per-stream, per-shard and fleet-level counters for the streaming runtime.

Tracks what a serving dashboard needs — frames/sec, streams/sec, step
latency percentiles, real-time factor, slot-pool resizes, per-shard
occupancy under a mesh — and bridges into the existing energy model
(core/energy.py): each steady-state hop has a statically known
MAC/SA/SRAM/cycle budget from the StreamPlan, so every hop charges a real
``EnergyLedger`` (the executor's accumulator, all components — not just
``e_mac``) and ``energy_summary`` reports the *measured*
silicon-equivalent TOPS/W the fleet would draw, in the paper's Table-I
accounting convention.

Step timing covers the whole per-hop pipeline *including* per-slot
finalized logits: finalization runs inside the batched step (the fused
tail), so there is no separate host-side peek bucket to account for — the
step latency percentile IS the hop-to-logits latency.  Each step records
its fenced per-phase split, as the scheduler's trace spans stamp it:
host pack (building the batched audio/mask from the shared
``RingArena``), dispatch, device (the fence and the result copies) and
the batched detector; ``phase_summary`` reports each phase's quantiles,
total and share of the hop (``host_pack_ms_p50/p95`` also in
``summary``).  Ingest (``push_audio_batch``) and joins are not hop
phases: their split is in the scheduler's ``push.*`` / ``join.*`` spans.

**Bounded over unbounded uptime.**  Nothing here grows with step count
or stream count: latencies land in fixed-size ring ``Reservoir``\\ s
(exact percentiles while the run is shorter than the window — every
test and bench — bit-identical to the old grow-forever lists) *and*
log-linear ``Histogram``\\ s (O(1)-memory estimates that cover every
sample ever recorded; ``summary()`` switches to them once a reservoir
wraps and says so via ``latency_estimated``).  Aggregates (frames,
stream-hops, per-shard hop totals, wall time) are running scalars, and
per-stream counter objects for closed streams retire into a bounded
ring.  ``footprint_bytes()`` exposes the retained size so the constant-
memory property is testable.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np

from repro_torch.core.energy import EnergyLedger, EnergyParams
from repro_torch.obs.registry import Histogram, MetricsRegistry, Reservoir
from repro_torch.stream.state import StreamPlan

# Three constants of the chip twin, copied until the twin itself is
# ported: macro.N_SA (sense amplifiers per macro), compiler._pad16
# (round up to a multiple of 16) and executor.READOUT_CYCLES
# (thermometer SA sweep per raw-output position per chunk).
N_SA = 128
READOUT_CYCLES = 8


def _pad16(x: int) -> int:
    return ((x + 15) // 16) * 16


# compiler.chunk_layer splits columns into one-SA-group chunks
_SA_GROUP = N_SA


def plan_hop_ledger(plan: StreamPlan,
                    params: EnergyParams | None = None) -> EnergyLedger:
    """Ledger for ONE stream advancing ONE steady-state hop.

    Charges exactly what the executor's per-chunk formulas would for the
    hop's incremental work: the conv cascade reads each layer's
    receptive-field window (tail ++ new frames) once per <=128-pair column
    chunk, activates ``rows x channels x positions x in_bits`` physical
    MACs, makes one SA decision per (position, pair, bit pass), and
    writes the pooled OFM back — the streaming specialization of
    ``Executor.run``'s MAC accounting, with the window length taken from
    the plan instead of the whole clip.  The classifier tail (fc cascade
    per emitted finalization) is charged separately by
    ``plan_tail_ledger`` so logits-off deployments don't pay for it.
    """
    led = EnergyLedger(params=params or EnergyParams())
    for st in plan.convs:
        rows = st.k * st.cin
        window = st.tail + st.n_in  # frames the hop streams past the macro
        positions = st.n_conv
        for c0 in range(0, st.cout, _SA_GROUP):
            n_ch = min(_SA_GROUP, st.cout - c0)
            pairs = _pad16(n_ch)
            led.charge_mac_op(
                rows * n_ch * positions,
                rows * n_ch * positions * st.in_bits,
                positions * pairs * st.in_bits,
                positions * st.in_bits,
            )
            led.charge_sram(
                read_bits=window * st.cin
                * (st.in_bits if st.in_bits > 1 else 1)
            )
        led.charge_sram(write_bits=st.n_out * st.cout)  # pooled OFM (PWB)
    # GAP: read the final frames, bump the saturating 8-bit counters
    last = plan.convs[-1]
    led.charge_sram(read_bits=last.n_out * plan.gap_channels,
                    write_bits=plan.gap_channels * 8)
    return led


def plan_tail_ledger(plan: StreamPlan,
                     params: EnergyParams | None = None) -> EnergyLedger:
    """Ledger for ONE finalization (classifier tail) of one stream.

    Drains the saturated GAP counts through the fc cascade: 8-bit counts
    feed the first fc bit-serially, raw-output layers pay the thermometer
    SA readout sweep, and each layer writes its activations back.
    """
    led = EnergyLedger(params=params or EnergyParams())
    for st in plan.fcs:
        rows = st.cin
        for c0 in range(0, st.cout, _SA_GROUP):
            n_ch = min(_SA_GROUP, st.cout - c0)
            pairs = _pad16(n_ch)
            cyc = st.in_bits + (READOUT_CYCLES if st.out_raw else 0)
            led.charge_mac_op(
                rows * n_ch,
                rows * n_ch * st.in_bits,
                pairs * st.in_bits,
                cyc,
            )
            led.charge_sram(
                read_bits=rows * (st.in_bits if st.in_bits > 1 else 1)
            )
        led.charge_sram(write_bits=st.cout * (8 if st.out_raw else 1))
    return led


_LEDGER_FIELDS: dict[type, tuple[str, ...]] = {}


def _charge_scaled(dst: EnergyLedger, src: EnergyLedger, n: int) -> None:
    """Accumulate ``n`` copies of ``src``'s charges into ``dst``.

    Field-generic — iterating ``dst``'s *runtime* dataclass fields
    (cached per runtime type; this runs twice per hop), not the static
    EnergyLedger class — so a counter added to EnergyLedger (or a
    subclass) can never be silently dropped from the streaming
    accumulation (tests/test_obs.py pins this with a grown ledger).
    """
    names = _LEDGER_FIELDS.get(type(dst))
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(dst)
                      if f.name != "params")
        _LEDGER_FIELDS[type(dst)] = names
    for name in names:
        setattr(dst, name, getattr(dst, name) + getattr(src, name) * n)


@dataclasses.dataclass
class StreamCounters:
    """Per-stream dashboard counters.

    ``detections`` updates live; ``samples_in`` (owned live by the shared
    arena's vectorized per-slot counter) and ``frames_out`` fold in when
    the stream closes — neither the hop hot path nor the bulk ingest path
    walks per-stream counter objects (fleet totals come from the
    step-level aggregates in ``StreamMetrics``).
    """

    stream_id: int
    joined_at: float
    samples_in: int = 0
    chunks_in: int = 0
    frames_out: int = 0
    detections: int = 0
    closed_at: float | None = None


# the fenced per-phase split of one hop (scheduler.step_batch's span
# stamps): host pack, dispatch (staging + batched call returning its
# futures), device (synchronize fence + result transfers), and the
# batched detector + bookkeeping
PHASES = ("pack", "dispatch", "device", "detector")


class StreamMetrics:
    """Aggregates per-stream counters + per-step wall latencies and the
    hop's fenced phase split (pack / dispatch / device / detector, the
    ``phase_summary`` the scheduler's spans stamp).

    Under a mesh (``n_shards > 1``) each step also records how many ready
    streams each shard advanced, so ``shard_summary`` can report per-shard
    occupancy/throughput next to the fleet aggregate.

    Every retained structure is bounded (see module docstring):
    ``reservoir`` raw samples per latency series, ``max_retained`` closed
    per-stream counter objects / capacity events.  Histograms registered
    in ``registry`` (a shared ``obs.MetricsRegistry``, or a private one)
    cover *all* samples in O(1) memory, so quantiles never go blind —
    they just degrade from exact to bounded-error once a window wraps.
    """

    def __init__(self, plan: StreamPlan, sample_rate: int = 16000,
                 n_shards: int = 1, registry: MetricsRegistry | None = None,
                 reservoir: int = 4096, max_retained: int = 1024) -> None:
        self.plan = plan
        self.sample_rate = sample_rate
        self.n_shards = n_shards
        self.registry = registry if registry is not None else MetricsRegistry()
        self.max_retained = max_retained
        self.streams: dict[int, StreamCounters] = {}
        # closed tenants of reused sids (bounded ring + exact total)
        self.retired: collections.deque[StreamCounters] = collections.deque(
            maxlen=max_retained
        )
        self.retired_total = 0
        # closed streams linger in ``streams`` for post-close inspection,
        # then the oldest are evicted so always-on churn can't leak
        self._closed_order: collections.deque = collections.deque()
        self.streams_total = 0   # every sid ever joined (exact)
        self.closed_total = 0
        self.detections_total = 0
        # latency series: exact ring reservoirs + all-sample histograms
        self._wall_res = Reservoir(reservoir)
        self._pack_res = Reservoir(reservoir)
        self._wall_hist = self._hist("stream.step_wall_s")
        self._pack_hist = self._hist("stream.step_pack_s")
        # the fenced per-phase split (pack shares the series above)
        self._phase_res = {p: Reservoir(reservoir) for p in PHASES[1:]}
        self._phase_hist = {p: self._hist(f"stream.phase_{p}_s")
                            for p in PHASES[1:]}
        # per-phase running totals (plain float adds on the hot path)
        self._phase_total = dict.fromkeys(PHASES, 0.0)
        # host work that ran under an in-flight device hop (async plane)
        self.hidden_total_s = 0.0
        self.steps = 0
        self.wall_total_s = 0.0
        self.stream_hops_total = 0
        self._shard_hops = np.zeros(n_shards, np.int64)
        self._frames_emitted = 0  # fleet total, accumulated per step
        # (t, new_cap) ring + exact resize count
        self.capacity_events: collections.deque = collections.deque(
            maxlen=max_retained
        )
        self.resize_count = 0
        # cross-shard migrations (scheduler._maybe_rebalance)
        self.rebalances = 0
        self.rows_migrated = 0
        # push-side fleet totals, folded from the arena's monotone scalar
        # counters at hop boundaries — the push path itself never touches
        # per-sid counter objects
        self.samples_pushed = 0
        self.chunks_pushed = 0
        # silicon-equivalent energy: static per-hop/-finalize charges from
        # the plan, accumulated into one fleet ledger as hops execute
        self._hop_ledger = plan_hop_ledger(plan)
        self._tail_ledger = plan_tail_ledger(plan)
        self.ledger = EnergyLedger()
        self.finalizations = 0
        # device launches counted over every shard: running total + the
        # last hop's; S times the per-shard figure
        # (``_BatchedModel.dispatches_per_hop``) over S shards
        self.device_launches_total = 0
        self._launches_per_hop = 0
        # tenant weight pool: admissions/evictions plus per-model
        # stream-hop counters.  Bounded — ``model_hops`` only holds
        # RESIDENT variants (<= pool size); an evicted model's count
        # retires into one scalar so always-on churn can't leak keys.
        self.models_admitted = 0
        self.models_evicted = 0
        self.model_hops: collections.Counter = collections.Counter()
        self.evicted_model_hops = 0
        self._t0 = time.perf_counter()

    def _hist(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    @staticmethod
    def _rec(res: Reservoir, hist: Histogram, v: float) -> None:
        """One latency sample into its reservoir + all-sample histogram.

        The histogram is *lazily backfilled*: while the reservoir still
        holds every sample (the exact regime) the histogram isn't
        touched; the moment the ring is about to wrap, the retained
        window bulk-folds in (``record_many``) and per-sample recording
        takes over — so the histogram still covers every sample ever,
        but the common pre-wrap hot path pays one ring write per series.
        """
        if res.count == res.capacity:
            hist.record_many(res.values())
        res.record(v)
        if res.count > res.capacity:
            hist.record(v)

    # -- recording -----------------------------------------------------------

    def on_join(self, sid: int) -> None:
        old = self.streams.get(sid)
        if old is not None:  # sid reuse: keep the first tenant's totals
            self.retired.append(old)
            self.retired_total += 1
        self.streams[sid] = StreamCounters(sid, time.perf_counter() - self._t0)
        self.streams_total += 1

    def on_step(self, n_ready: int, frames_each: int, wall_s: float,
                host_pack_s: float = 0.0,
                shard_counts: list[int] | None = None,
                finalized: bool = True,
                dispatch_s: float = 0.0, device_s: float = 0.0,
                detector_s: float = 0.0, hidden_s: float = 0.0,
                dispatches: int = 0,
                model_counts: dict[str, int] | None = None) -> None:
        """Record one batched hop: ``n_ready`` streams advanced in
        ``wall_s`` seconds of which ``host_pack_s`` was host-side batch
        packing; ``dispatch_s``/``device_s``/``detector_s`` are the
        fenced phase durations from the scheduler's trace spans (device
        time is real execution — the span boundary blocks until ready).
        ``hidden_s`` is the portion of this hop's host work (pack /
        dispatch / deferred fold) that ran while an earlier or later hop
        was executing on the device — zero on the synchronous path,
        reported by the async plane's pipelined dispatch.  ``dispatches``
        is the hand-written kernel launches the hop made, counted over
        every shard: S times the per-shard figure
        (``dispatches_per_hop``), 0 for the dense backend.
        ``model_counts`` (tenant pools only)
        says how many of this hop's stream-hops each resident model
        advanced — one small dict add per hop, K-bounded.
        Aggregate-only — the hot path never walks per-stream counter
        objects (that was the pre-arena serial floor)."""
        if shard_counts is None:
            # only unambiguous without a mesh; sharded callers must say
            # which shard advanced what or shard_summary would lie
            assert self.n_shards == 1, "shard_counts required when sharded"
            shard_counts = [n_ready]
        assert len(shard_counts) == self.n_shards, (shard_counts, self.n_shards)
        self._rec(self._wall_res, self._wall_hist, wall_s)
        self._rec(self._pack_res, self._pack_hist, host_pack_s)
        pt = self._phase_total
        pt["pack"] += host_pack_s
        for p, v in (("dispatch", dispatch_s), ("device", device_s),
                     ("detector", detector_s)):
            self._rec(self._phase_res[p], self._phase_hist[p], v)
            pt[p] += v
        self.hidden_total_s += hidden_s
        self.device_launches_total += dispatches
        self._launches_per_hop = dispatches
        self.steps += 1
        self.wall_total_s += wall_s
        self.stream_hops_total += n_ready
        if self.n_shards == 1:
            self._shard_hops[0] += shard_counts[0]
        else:
            self._shard_hops += np.asarray(shard_counts, np.int64)
        self._frames_emitted += n_ready * frames_each
        if model_counts:
            self.model_hops.update(model_counts)
        _charge_scaled(self.ledger, self._hop_ledger, n_ready)
        if finalized:
            _charge_scaled(self.ledger, self._tail_ledger, n_ready)
            self.finalizations += n_ready

    def on_detection(self, sid: int) -> None:
        self.streams[sid].detections += 1
        self.detections_total += 1

    def on_resize(self, new_capacity: int) -> None:
        """Elastic slot pool grew or shrank (scheduler._resize)."""
        self.capacity_events.append(
            (time.perf_counter() - self._t0, new_capacity)
        )
        self.resize_count += 1

    def on_rebalance(self, n_moves: int) -> None:
        """One cross-shard migration leveled the pool with ``n_moves``
        slot rows crossing shard blocks."""
        self.rebalances += 1
        self.rows_migrated += n_moves

    def on_model_admit(self, model_id: str) -> None:
        """One tenant variant admitted to the weight pool."""
        self.models_admitted += 1
        self.model_hops.setdefault(model_id, 0)

    def on_model_evict(self, model_id: str) -> None:
        """One tenant variant evicted (LRU): its hop count retires into
        the scalar so ``model_hops`` stays bounded by pool size."""
        self.models_evicted += 1
        self.evicted_model_hops += self.model_hops.pop(model_id, 0)

    def on_push_fold(self, samples_total: int, chunks_total: int) -> None:
        """Hop-boundary fold of the arena's monotone push counters (two
        absolute scalars — O(1) regardless of stream count)."""
        self.samples_pushed = int(samples_total)
        self.chunks_pushed = int(chunks_total)

    def on_close(self, sid: int, frames_out: int = 0,
                 samples_in: int | None = None,
                 chunks_in: int | None = None) -> None:
        c = self.streams[sid]
        c.closed_at = time.perf_counter() - self._t0
        c.frames_out = frames_out
        if samples_in is not None:
            # the shared arena's vectorized per-slot counters are the
            # truth; they fold in here instead of being twinned per push
            c.samples_in = samples_in
        if chunks_in is not None:
            c.chunks_in = chunks_in
        self.closed_total += 1
        # closed counters stay inspectable for a while, then the oldest
        # evict — an always-on runtime churns through millions of sids
        self._closed_order.append((sid, c))
        while len(self._closed_order) > self.max_retained:
            old_sid, old_c = self._closed_order.popleft()
            if self.streams.get(old_sid) is old_c:
                del self.streams[old_sid]

    def begin_window(self) -> None:
        """Start a fresh measurement window: resets the latency series
        and the step/throughput aggregates (NOT lifecycle counters or the
        energy ledger, which stay cumulative).  Benches call this after
        warm-up so ``summary()`` reports steady-state quantiles."""
        for r in (self._wall_res, self._pack_res,
                  *self._phase_res.values()):
            r.reset()
        for h in (self._wall_hist, self._pack_hist,
                  *self._phase_hist.values()):
            h.reset()
        self._phase_total = dict.fromkeys(PHASES, 0.0)
        self.hidden_total_s = 0.0
        self.device_launches_total = 0
        self.steps = 0
        self.wall_total_s = 0.0
        self.stream_hops_total = 0
        self._shard_hops[:] = 0
        self._frames_emitted = 0

    # -- reporting -----------------------------------------------------------

    def frames_total(self) -> int:
        """Fleet total of final-conv frames emitted by batched hops
        (since construction or the last ``begin_window``)."""
        return self._frames_emitted

    @property
    def latency_estimated(self) -> bool:
        """True once any latency reservoir has wrapped: quantiles now
        come from the log-linear histograms (bounded relative error,
        covering every sample) instead of exact order statistics."""
        return self._wall_res.saturated

    def _q(self, res: Reservoir, hist: Histogram, q: float) -> float:
        """Quantile in ms: exact from the reservoir while it still holds
        every sample, histogram estimate (all samples, bounded error)
        after it wraps; NaN when nothing was recorded."""
        if res.count == 0:
            return math.nan
        if not res.saturated:
            return float(np.percentile(res.values(), q) * 1e3)
        return hist.quantile(q / 100.0) * 1e3

    def summary(self) -> dict[str, float]:
        """Fleet aggregate.  Latency fields are NaN (not a fabricated
        0.0) when no step has been recorded; ``latency_estimated`` flips
        to 1.0 once quantiles switch from exact to histogram-estimated.
        """
        frames = self.frames_total()
        elapsed = self.wall_total_s or 1e-12
        audio_s = frames * self.plan.samples_per_frame / self.sample_rate
        return {
            "streams": float(self.streams_total),
            "steps": float(self.steps),
            "frames_total": float(frames),
            "frames_per_sec": frames / elapsed,
            "stream_hops_per_sec": self.stream_hops_total / elapsed,
            "audio_sec_per_wall_sec": audio_s / elapsed,  # real-time factor
            "step_ms_p50": self._q(self._wall_res, self._wall_hist, 50),
            "step_ms_p95": self._q(self._wall_res, self._wall_hist, 95),
            "step_ms_p99": self._q(self._wall_res, self._wall_hist, 99),
            "step_ms_p999": self._q(self._wall_res, self._wall_hist, 99.9),
            # host pack: building the batched audio+mask from the arena
            # (the other phases: ``phase_summary``)
            "host_pack_ms_p50": self._q(self._pack_res, self._pack_hist, 50),
            "host_pack_ms_p95": self._q(self._pack_res, self._pack_hist, 95),
            "latency_estimated": float(self.latency_estimated),
            "mean_batch_occupancy": self.stream_hops_total / self.steps
            if self.steps else 0.0,
            "resizes": float(self.resize_count),
            "capacity_last": float(self.capacity_events[-1][1])
            if self.capacity_events else 0.0,
            "n_shards": float(self.n_shards),
            "rebalances": float(self.rebalances),
            "rows_migrated": float(self.rows_migrated),
            "samples_pushed": float(self.samples_pushed),
            "chunks_pushed": float(self.chunks_pushed),
            # device-launch accounting (0 under the dense backend): the
            # launches counted over every shard, last hop's and the
            # total, and the same per shard (the reference's
            # ``dispatches_per_hop`` figure), S times fewer
            "device_launches_per_hop": float(self._launches_per_hop),
            "device_launches_total": float(self.device_launches_total),
            "device_dispatches_per_hop":
                self._launches_per_hop / self.n_shards,
            "device_dispatches_total":
                self.device_launches_total / self.n_shards,
        }

    def tenant_summary(self) -> dict[str, object]:
        """Weight-pool accounting: admissions/evictions plus stream-hops
        advanced per resident tenant.  ``per_model`` is bounded by the
        pool's ``max_models`` — evicted tenants' hop counts retire into
        the ``evicted_model_hops`` scalar instead of growing the dict."""
        return {
            "models_admitted": float(self.models_admitted),
            "models_evicted": float(self.models_evicted),
            "evicted_model_hops": float(self.evicted_model_hops),
            "per_model": {m: int(c) for m, c in self.model_hops.items()},
        }

    def phase_summary(self) -> dict[str, dict[str, float]]:
        """Per-phase hop breakdown (pack / dispatch / device / detector):
        quantiles in ms plus each phase's share of total hop wall time.
        The fenced spans tile the hop, so shares sum to ~1 when the
        scheduler recorded all phases (0 for phases never recorded)."""
        series: dict[str, tuple[Reservoir, Histogram]] = {
            "pack": (self._pack_res, self._pack_hist)
        }
        series.update({p: (self._phase_res[p], self._phase_hist[p])
                       for p in PHASES[1:]})
        wall_total = self.wall_total_s
        out: dict[str, dict[str, float]] = {}
        for name, (res, hist) in series.items():
            total = self._phase_total[name]
            out[name] = {
                "ms_p50": self._q(res, hist, 50),
                "ms_p95": self._q(res, hist, 95),
                "ms_p99": self._q(res, hist, 99),
                "ms_p999": self._q(res, hist, 99.9),
                "total_s": total,
                "share_of_wall": total / wall_total if wall_total else 0.0,
            }
        return out

    def overlap_summary(self) -> dict[str, float]:
        """How much host-side hop work the async plane hid under device
        compute this window.  ``hidden_frac`` is hidden host seconds over
        total host seconds (pack + dispatch + detector); always 0.0 under
        the synchronous scheduler.  The trace-derived union-interval
        stats (``obs.trace.overlap_stats``) are the precise wall-clock
        account; this is the O(1) running-counter view."""
        pt = self._phase_total
        host = pt["pack"] + pt["dispatch"] + pt["detector"]
        return {
            "hidden_ms": self.hidden_total_s * 1e3,
            "host_ms": host * 1e3,
            "hidden_frac": self.hidden_total_s / host if host else 0.0,
            "device_busy_ms": pt["device"] * 1e3,
        }

    def shard_summary(self) -> dict[str, object]:
        """Per-shard occupancy/throughput + the fleet aggregate.

        ``per_shard[s]`` reports how many stream-hops shard ``s`` advanced
        and its mean per-step occupancy; ``imbalance`` is the max/mean
        stream-hop ratio (1.0 = perfectly balanced placement — a dead
        shard with zero hops inflates it, since the mean keeps counting
        that shard).
        """
        S = self.n_shards
        hops = self._shard_hops
        steps = max(1, self.steps)
        mean_hops = float(hops.mean()) if S else 0.0
        return {
            "n_shards": S,
            "per_shard": [
                {
                    "shard": sh,
                    "stream_hops": int(hops[sh]),
                    "mean_occupancy": float(hops[sh] / steps),
                }
                for sh in range(S)
            ],
            "fleet_stream_hops": int(hops.sum()),
            "imbalance": float(hops.max() / mean_hops) if hops.sum() else 1.0,
        }

    def footprint_bytes(self) -> int:
        """Retained-memory proxy: array bytes of every bounded instrument
        plus an entry-count charge for the dict/deque containers.  The
        constant-memory-over-10k-steps test pins this value flat."""
        n = sum(r.nbytes for r in (self._wall_res, self._pack_res,
                                   *self._phase_res.values()))
        n += sum(h.nbytes for h in (self._wall_hist, self._pack_hist,
                                    *self._phase_hist.values()))
        n += self._shard_hops.nbytes
        n += 64 * (len(self.streams) + len(self.retired)
                   + len(self.capacity_events) + len(self._closed_order)
                   + len(self.model_hops))
        return n

    def energy_summary(self, params: EnergyParams | None = None) -> dict[str, float]:
        """Measured silicon-equivalent cost of the work done so far.

        Every hop charged the fleet ``EnergyLedger`` with the full Table-I
        component model (macro MACs, SA decisions, feature-SRAM traffic,
        controller cycles) from the plan's static per-hop geometry, so
        this is the executor's accounting applied to the streaming
        workload — not an e_mac-only estimate.  ``uj_per_inference`` is
        the energy per finalized per-hop decision (the always-on "answer
        now" cost).
        """
        led = self.ledger
        if params is not None:
            led = dataclasses.replace(led, params=params)
        p = led.params
        energy_j = led.energy_j
        return {
            "macs_total": float(led.macs),
            "phys_macs_total": float(led.phys_macs),
            "sa_decisions_total": float(led.sa_decisions),
            "sram_bits_total": float(
                led.sram_read_bits + led.sram_write_bits
            ),
            "cycles_total": float(led.cycles),
            "energy_uj": energy_j * 1e6,
            "e_mac_uj": p.e_mac * led.phys_macs * 1e6,
            "e_sa_uj": p.e_sa * led.sa_decisions * 1e6,
            "e_sram_uj": (p.e_sram_r * led.sram_read_bits
                          + p.e_sram_w * led.sram_write_bits) * 1e6,
            "e_ctrl_uj": p.e_ctrl * led.cycles * 1e6,
            "tops_per_w_equiv": led.tops_per_w,
            "uj_per_inference": (energy_j * 1e6 / self.finalizations)
            if self.finalizations else 0.0,
        }
