"""Continuous-batching multi-stream scheduler for always-on KWS (PyTorch).

The port of the reference's ``repro/stream/scheduler.py``, single device,
synchronous and single tenant.  Thousands of concurrent audio streams each
produce frames continuously; the model weights are shared across all of
them.  The scheduler packs the active streams onto an *elastic* batch axis
and advances them with ONE batched step per hop:

  * streams join/leave at any time — a free slot is primed from the
    stream's first ``prime_samples`` (``state.prime_batch``, numpy) and
    from then on rides the static-shape batched step;
  * streams whose inbox holds less than a hop are masked out of the step
    (their state passes through untouched) — continuous batching;
  * the ingest plane is struct-of-arrays (``state.RingArena``): one
    vectorized gather packs every ready inbox, one scatter lands a push
    batch, and detection advances through the slot-vectorized
    ``BatchedDetector`` — no per-slot python on the hop path;
  * the slot pool grows and shrinks at power-of-two sizes
    (``runtime.SlotPool``); a resize pads/slices the batched ring state,
    so results stay bit-exact across the resize boundary.

Three backends compute the hop:

  * ``"megakernel"`` (default): ONE launch of the hand-written CUDA hop
    kernel per hop (``kernels/hop_megakernel.py``) — bit-serial layer 0,
    SA, pool phases, tail/pending carry, GAP, mask merge and, on emit
    hops, the ghost flush and the classifier.  Hop-boundary peeks that no
    emit covers take one launch of the same kernel in finalize mode.  On
    CPU tensors the kernel's plain PyTorch version stands in for it.
  * ``"per_stage"``: the reference's per-stage kernel backend (its
    ``"pallas"``), an independent oracle of the megakernel — one launch
    per conv stage per hop (the bit-serial B.3 step for a multi-bit
    input, else the B.4 popcount conv in raw mode), SA, pooling, GAP and
    the mask merge as tensor ops, and on emit hops one launch per
    ghost-flush conv plus the B.5 classifier tail
    (``kernels/bnn_conv1d.py``).  Chosen only when asked for.
  * ``"torch"``: the dense twin of the reference's ``"jnp"`` backend —
    plain tensor ops, integer contractions in float64 (exact here: every
    accumulator is far below 2^53), no hand-written kernel.

Per emit hop the step also returns every slot's finalized logits — the
exact logits the offline executor would produce if the utterance ended at
this hop — and softmax posteriors.  ``StreamState.peek_logits`` (numpy)
stays the exact fallback for peeks over leftover sub-hop samples.

Not ported yet, and refused with ``NotImplementedError``: a device mesh
(queue item A.9), the multi-tenant weight pool (``max_models > 1``, A.8),
and donated state buffers and the async plane (A.7).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cnn_spec import CNN1DSpec
from repro_torch.kernels import dispatch, ops
from repro_torch.obs import Observability
from repro_torch.runtime.pool import SlotPool
from repro_torch.stream.detector import (
    BatchedDetector,
    Detection,
    DetectorConfig,
    _softmax,
)
from repro_torch.stream.frontend import AudioFrontend, FrontendConfig
from repro_torch.stream.metrics import StreamMetrics
from repro_torch.stream.state import (
    RingArena,
    StreamPlan,
    StreamState,
    plan_stream,
    prime_batch,
    quantize_pcm,
    remap_rows,
)
BACKENDS = ("torch", "megakernel", "per_stage")

# ---------------------------------------------------------------------------
# Memoized parameter prep (exported numpy dicts -> device tensors)
# ---------------------------------------------------------------------------
#
# The cache keys on the *identity* of the weights/thresholds dicts plus the
# plan geometry and the device, holds strong references to the keyed dicts
# (so an id can never be recycled under us; an identity check guards the
# lookup anyway), and is bounded LRU.

_PARAM_CACHE: collections.OrderedDict = collections.OrderedDict()
_PARAM_CACHE_MAX = 64
_param_cache_hits = 0
_param_cache_misses = 0


def prepared_model_params(plan: StreamPlan, weights, thresholds,
                          device="cuda") -> dict:
    """Device tensors for one exported model, memoized by ``(id(weights),
    id(thresholds), plan geometry, device)``.

    Takes what ``repro.models.kws.export_kws`` returns — numpy int8
    ternary ``weights`` and ``thresholds`` of float64 integer thresholds
    (``±inf`` where the affine scale is 0) with bool flips — and returns
    ``{"w", "thr", "flip", "fc_w", "fc_thr", "fc_flip"}`` with the
    reference's dtypes: int32 ``(k, cin, cout)`` conv weights, float32
    thresholds, bool conv flips, int32 fc weights and flips.
    """
    global _param_cache_hits, _param_cache_misses
    device = torch.device(device)
    key = (id(weights), id(thresholds), plan.convs, plan.fcs, str(device))
    hit = _PARAM_CACHE.get(key)
    if (hit is not None and hit["weights"] is weights
            and hit["thresholds"] is thresholds):
        _param_cache_hits += 1
        _PARAM_CACHE.move_to_end(key)
        return hit
    _param_cache_misses += 1

    def put(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    stages = plan.convs
    prep = {
        # strong refs pin the keyed ids for the cache's lifetime
        "weights": weights,
        "thresholds": thresholds,
        "w": [put(weights[st.layer_idx].reshape(st.k, st.cin, st.cout),
                  torch.int32) for st in stages],
        "thr": [put(thresholds[st.layer_idx][0], torch.float32)
                for st in stages],
        "flip": [put(thresholds[st.layer_idx][1], torch.bool)
                 for st in stages],
        "fc_w": tuple(put(weights[st.layer_idx], torch.int32)
                      for st in plan.fcs),
        "fc_thr": tuple(put(thresholds[st.layer_idx][0], torch.float32)
                        for st in plan.fcs),
        "fc_flip": tuple(put(thresholds[st.layer_idx][1], torch.int32)
                         for st in plan.fcs),
    }
    _PARAM_CACHE[key] = prep
    while len(_PARAM_CACHE) > _PARAM_CACHE_MAX:
        _PARAM_CACHE.popitem(last=False)
    return prep


def param_cache_stats() -> dict[str, int]:
    """Hit/miss counters for the memoized parameter prep (tests)."""
    return {
        "hits": _param_cache_hits,
        "misses": _param_cache_misses,
        "size": len(_PARAM_CACHE),
    }


@dataclasses.dataclass
class StreamResult:
    """Returned by close_stream: the stream's final, flushed inference."""

    stream_id: int
    logits: np.ndarray        # executor-exact raw logits
    frames: int               # final-conv frames accumulated
    samples: int
    events: list[Detection]


@dataclasses.dataclass
class HopBatch:
    """One batched hop's results in columnar (struct-of-arrays) form —
    what ``step_batch`` returns without ever materializing per-stream
    python objects.  ``detections`` is sparse: one entry per fired event,
    usually empty."""

    sids: np.ndarray                 # (R,) stream ids advanced this hop
    frames: np.ndarray               # (R,) final-conv frame counts after it
    logits: np.ndarray | None        # (R, n_classes) finalized logits
    posteriors: np.ndarray | None    # (R, n_classes) on-device softmax
    detections: list[Detection]


@dataclasses.dataclass
class _Stream:
    sid: int
    slot: int
    frontend: AudioFrontend   # facade over the shared arena row
    events: list[Detection]
    primed: bool = False
    stamp: int = 0  # emit-step from which cached hop logits cover this slot


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "StreamScheduler(device='cuda') needs a CUDA device and none "
            "is available; pass device='cpu' to run the plain version"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class _BatchedModel:
    """Device-resident model + batched hop/finalize for one plan.

    Batch-size polymorphic: every entry point derives B from its operands,
    so the elastic slot pool needs nothing per capacity.
    """

    def __init__(self, plan: StreamPlan, backend: str, params: dict) -> None:
        self.plan = plan
        self.backend = backend
        self._w = list(params["w"])
        self._thr = list(params["thr"])
        self._flip = list(params["flip"])
        self._fc_w = tuple(params["fc_w"])
        self._fc_thr = tuple(params["fc_thr"])
        self._fc_flip = tuple(params["fc_flip"])
        self._fc_raw = tuple(st.out_raw for st in plan.fcs)
        if backend == "megakernel":
            # the kernel's operand types, converted once: int8 ternary
            # weights, int32 flips
            self._kw = tuple(w.to(torch.int8) for w in self._w)
            self._kflip = tuple(f.to(torch.int32) for f in self._flip)
            self._kfc_w = tuple(w.to(torch.int8) for w in self._fc_w)
        elif backend == "per_stage":
            # the per-stage kernels' operands, prepared once: int8
            # weights, packed pos/neg planes and sum(w) per conv layer,
            # int8 fc weights (thresholds are float32 and fc flips int32
            # in the prepared params already)
            self._cw = tuple(ops.conv_weights(w) for w in self._w)
            self._kfc_w = tuple(w.to(torch.int8) for w in self._fc_w)

    # -- shared conv math (dense and per-stage backends) --------------------

    @staticmethod
    def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact integer contraction through float64 (CUDA has no int32
        GEMM; every partial sum here is far below 2^53)."""
        return torch.einsum(eq, a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)

    def _conv_raw(self, i: int, window: torch.Tensor, n_conv: int
                  ) -> torch.Tensor:
        """(B, len, Cin) window -> (B, n_conv, Cout) raw conv: one B.3
        or B.4 launch on the per-stage backend, a dense contraction on the
        torch backend."""
        st = self.plan.convs[i]
        if self.backend == "per_stage":
            if st.in_bits > 1:
                return ops.bitserial_conv1d_batched(
                    window, self._cw[i], bits=st.in_bits,
                    offset=st.in_offset, stride=st.stride)
            return ops.bnn_conv1d_batched(window, self._cw[i],
                                          stride=st.stride, mode="raw")
        x = window - st.in_offset if st.in_bits > 1 else window
        taps = [
            x[:, t : t + (n_conv - 1) * st.stride + 1 : st.stride]
            for t in range(st.k)
        ]
        return self._contract("bknc,kco->bno", torch.stack(taps, 1),
                              self._w[i])

    def _sa(self, i: int, raw: torch.Tensor) -> torch.Tensor:
        """SA binarization, executor-exact: integer thresholds make the
        float32 compare knife-edge free."""
        ge = raw.to(torch.float32) >= self._thr[i]
        return torch.where(self._flip[i], ~ge, ge).to(torch.int32)

    # -- the hop -------------------------------------------------------------

    def step(self, audio, mask, tails, pendings, gap, *, emit: bool):
        """One batched hop; with ``emit`` also per-slot finalized logits +
        posteriors.  ``mask`` (B,) bool selects the slots that advance."""
        plan = self.plan
        stages = plan.convs
        cur = audio.reshape(audio.shape[0], plan.hop_samples, stages[0].cin)
        if self.backend == "megakernel":
            out = ops.hop_megakernel(
                cur, mask.to(torch.int32), tuple(tails), tuple(pendings),
                gap, self._kw, self._thr, self._kflip, self._kfc_w,
                self._fc_thr, self._fc_flip, stages=stages, emit=emit,
                fc_raw=self._fc_raw,
            )
            state = out[0], out[1], out[2]
            if not emit:
                return state
            logits = out[3]
            return (*state, logits, torch.softmax(logits.float(), -1))
        new_tails, new_pendings = [], []
        for i, st in enumerate(stages):
            window = torch.cat([tails[i], cur], 1)
            raw = self._conv_raw(i, window, st.n_conv)
            new_tails.append(window[:, st.n_conv * st.stride :])
            y = self._sa(i, raw)
            if st.pool > 1:
                frames = torch.cat([pendings[i], y], 1) if st.phase else y
                used = st.n_out * st.pool
                pooled = frames[:, :used].reshape(
                    frames.shape[0], st.n_out, st.pool, st.cout
                ).amax(2)
                new_pendings.append(frames[:, used:])
                cur = pooled
            else:
                new_pendings.append(pendings[i])
                cur = y
        # saturate at the 8-bit PWB counter ceiling every hop: the
        # accumulation is monotone non-negative, so incremental clamping
        # equals clamping the total and int32 never wraps
        gap2 = torch.clamp(gap + cur.sum(1, dtype=torch.int32), max=255)
        m3 = mask[:, None, None]
        new_tails = [torch.where(m3, nt, t)
                     for nt, t in zip(new_tails, tails)]
        new_pendings = [
            torch.where(m3, np_, p) if p.shape[1] else p
            for np_, p in zip(new_pendings, pendings)
        ]
        gap2 = torch.where(mask[:, None], gap2, gap)
        state = tuple(new_tails), tuple(new_pendings), gap2
        if not emit:
            return state
        # finalization on the merged state: masked rows hold their
        # previous (still steady) state, so every primed slot's logits
        # are valid
        logits, post = self.finalize(*state)
        return (*state, logits, post)

    # -- finalization tail ---------------------------------------------------

    def finalize(self, tails, pendings, gap):
        """Logits/posteriors as if every stream ended at this hop boundary:
        a ghost end-of-stream flush sized by the plan's ``flush_*``
        geometry, then the fc classifier on the saturated GAP counts."""
        if self.backend == "megakernel":
            logits = ops.finalize_megakernel(
                tuple(tails), tuple(pendings), gap, self._kw, self._thr,
                self._kflip, self._kfc_w, self._fc_thr, self._fc_flip,
                stages=self.plan.convs, fc_raw=self._fc_raw,
            )
            return logits, torch.softmax(logits.float(), -1)
        stages = self.plan.convs
        B = gap.shape[0]
        cur = None  # frames flowing down from the layer above's flush
        for i, st in enumerate(stages):
            pieces = [tails[i]]
            if cur is not None and st.flush_in:
                pieces.append(cur)
            if st.pad:
                pad_val = st.in_offset if st.in_bits > 1 else 0
                pieces.append(torch.full((B, st.pad, st.cin), pad_val,
                                         dtype=torch.int32,
                                         device=gap.device))
            if st.flush_conv > 0:
                window = torch.cat(pieces, 1)
                y = self._sa(i, self._conv_raw(i, window, st.flush_conv))
            else:
                y = torch.zeros((B, 0, st.cout), dtype=torch.int32,
                                device=gap.device)
            frames = torch.cat([pendings[i], y], 1)
            used = st.flush_out * st.pool  # drop-remainder (ref_maxpool1d)
            cur = frames[:, :used].reshape(
                B, st.flush_out, st.pool, st.cout
            ).amax(2)
        gap_f = torch.clamp(gap + cur.sum(1, dtype=torch.int32), max=255)
        logits = self._classifier(gap_f)
        return logits, torch.softmax(logits.float(), -1)

    def _classifier(self, gap_f: torch.Tensor) -> torch.Tensor:
        """Saturated GAP counts (B, C) -> raw logits (B, n_classes)."""
        if self.backend == "per_stage":
            return ops.classifier_tail(gap_f, self._kfc_w, self._fc_thr,
                                       self._fc_flip, out_raw=self._fc_raw)
        h = gap_f
        for j, st in enumerate(self.plan.fcs):
            raw = self._contract("bc,co->bo", h, self._fc_w[j])
            if st.out_raw:
                h = raw
            else:
                ge = raw.to(torch.float32) >= self._fc_thr[j]
                h = torch.where(self._fc_flip[j] != 0, ~ge, ge).to(
                    torch.int32)
        return h

    def dispatches_per_hop(self, emit: bool) -> int:
        """Hand-written kernel launches one hop makes: 1 for the
        megakernel (emit's flush + classifier ride the same launch), 0 for
        the dense backend, and for the per-stage backend one per conv
        stage plus, on emit, a finalization's launches.  The scheduler
        counts the real launches of every hop through ``kernels.dispatch``
        and the tests hold the two equal."""
        if self.backend == "per_stage":
            n = len(self.plan.convs)
            return n + (self.dispatches_per_finalize() if emit else 0)
        return 1 if self.backend == "megakernel" else 0

    def dispatches_per_finalize(self) -> int:
        """Launches of one standalone finalization (a hop-boundary peek no
        emit covers): 1 for the megakernel, 0 for the dense backend, and
        for the per-stage backend one per ghost-flush conv with
        ``flush_conv > 0`` plus the classifier tail."""
        if self.backend == "per_stage":
            return sum(1 for st in self.plan.convs if st.flush_conv > 0) + 1
        return 1 if self.backend == "megakernel" else 0


class StreamScheduler:
    """Continuous batching over an elastic pool of stream slots.

    ``capacity`` is the *ceiling*: the pool starts at ``initial_capacity``
    (default ``min_capacity``) and doubles on demand up to the ceiling;
    ``close_stream`` halves it once occupancy falls to a quarter (never
    below ``min_capacity`` — set ``min_capacity == capacity`` to pin a
    fixed-size pool).  Each resize is a pure pad/slice of the batched ring
    state, so a stream fed across a resize boundary produces bit-identical
    logits to one fed at a fixed capacity.

    Takes the reference's constructor arguments plus ``device`` (default
    ``"cuda"``; raises when CUDA is absent, never continues on the CPU).
    ``interpret`` and ``tenant_block`` have no meaning here (there is no
    interpret mode, and no tenant pool) and are accepted for signature
    parity.  ``mesh``, ``max_models > 1`` and ``donate_buffers`` raise
    ``NotImplementedError``.
    """

    def __init__(
        self,
        spec: CNN1DSpec,
        weights: dict[int, np.ndarray],
        thresholds: dict[int, tuple[np.ndarray, np.ndarray]],
        capacity: int = 8,
        hop_frames: int = 1,
        backend: str = "megakernel",
        interpret: bool | None = None,
        detector_cfg: DetectorConfig | None = None,
        emit_logits: bool = True,
        sample_rate: int = 16000,
        initial_capacity: int | None = None,
        min_capacity: int | None = None,
        mesh=None,
        inbox_samples: int | None = None,
        rebalance_threshold: int | None = 1,
        obs: Observability | None = None,
        clock=time.perf_counter,
        donate_buffers: bool = False,
        max_models: int = 1,
        tenant_block: int = 8,
        prewarm: bool = False,
        device="cuda",
    ) -> None:
        if backend == "pallas":
            raise ValueError(
                "backend='pallas' names the reference's TPU kernels; the "
                "port's per-stage kernel backend is 'per_stage'")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded slot pools are not ported yet: ROADMAP queue "
                "item A.9")
        if max_models != 1:
            raise NotImplementedError(
                "the multi-tenant weight pool (max_models > 1) is not "
                "ported yet: ROADMAP queue item A.8")
        if donate_buffers:
            raise NotImplementedError(
                "donated state buffers belong to the async plane, not "
                "ported yet: ROADMAP queue item A.7")
        self.device = _require_device(device)
        self._clock = clock
        self.plan = plan_stream(spec, hop_frames=hop_frames)
        self.weights = {k: np.asarray(v) for k, v in weights.items()}
        self.thresholds = thresholds
        self.backend = backend
        self.detector_cfg = detector_cfg or DetectorConfig()
        self.emit_logits = emit_logits
        self.obs = obs if obs is not None else Observability.create()
        self.metrics = StreamMetrics(self.plan, sample_rate, n_shards=1,
                                     registry=self.obs.registry)
        self._params = prepared_model_params(self.plan, weights, thresholds,
                                             self.device)
        self._model = _BatchedModel(self.plan, backend, self._params)
        # the generic slot-pool plane: slot<->sid binding, pow-2 elastic
        # resize, idle-time prewarm, resize observability.  This scheduler
        # is its client through device_state/slot_axes/shard/
        # apply_host_remap below.
        self._slots = SlotPool(
            self, capacity,
            initial_capacity=initial_capacity,
            min_capacity=min_capacity,
            n_shards=1,
            rebalance_threshold=rebalance_threshold,
            obs=self.obs,
            on_resize=self.metrics.on_resize,
            on_rebalance=self.metrics.on_rebalance,
            prewarm=prewarm,
            clock=self._clock,
        )
        cap0 = self._slots.capacity
        # batched state lives on the device between hops; host copies are
        # made only on join/leave or fallback peeks — never the hot loop
        self._tails = [self._zeros((cap0, st.tail, st.cin))
                       for st in self.plan.convs]
        self._pendings = [self._zeros((cap0, st.phase, st.cout))
                          for st in self.plan.convs]
        self._gap = self._zeros((cap0, self.plan.gap_channels))
        base_inbox = (
            inbox_samples if inbox_samples is not None
            else FrontendConfig().capacity_samples
        )
        # whole hops only: keeps primed slots on pack_hops' block-aligned
        # contiguous fast path (see RingArena.rebase)
        hop = self.plan.hop_samples
        self._inbox_samples = -(-base_inbox // hop) * hop
        self._arena = RingArena(cap0, self._inbox_samples)
        self._detector = BatchedDetector(
            cap0, self.plan.fcs[-1].cout, self.detector_cfg
        )
        self._slot_sid = np.full(cap0, -1, np.int64)
        self._primed_mask = np.zeros(cap0, bool)
        self._frames_v = np.zeros(cap0, np.int64)  # frames per slot
        self._streams: dict[int, _Stream] = {}
        self._unprimed: set[int] = set()  # empty in steady state
        self._next_sid = 0
        # hop-boundary peeks are served from the last emit step's logits:
        # the finalization covers EVERY primed slot (masked rows hold
        # steady state), so the row stays valid until the slot is
        # rewritten on the host (priming) or remapped (resize)
        self._emit_step = 0
        self._emit_cache: np.ndarray | None = None
        self._emit_cache_step = -1
        self._warmed: set[tuple[int, bool]] = set()
        self._last_dispatches = 0

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _sync(self) -> None:
        """Fence: wait for the device work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- elastic slot pool (delegated to runtime.SlotPool) -------------------

    @property
    def capacity(self) -> int:
        """Current pool size (<= ``max_capacity``)."""
        return self._slots.capacity

    @property
    def max_capacity(self) -> int:
        """Capacity ceiling the elastic pool doubles toward."""
        return self._slots.max_capacity

    # -- SlotPool client surface (see runtime.pool.SlotPoolClient) -----------

    def device_state(self):
        """The per-slot device state the pool resizes/remaps: conv tails,
        pool pendings, GAP counters (slot axis 0 everywhere)."""
        return (tuple(self._tails), tuple(self._pendings), self._gap)

    def set_device_state(self, state) -> None:
        tails, pendings, gap = state
        self._tails = list(tails)
        self._pendings = list(pendings)
        self._gap = gap

    def slot_axes(self):
        n = len(self.plan.convs)
        return ((0,) * n, (0,) * n, 0)

    def shard(self, x, axis: int = 0):
        return x  # one device: nothing to settle

    def apply_host_remap(self, remap: dict[int, int], new_cap: int) -> None:
        """Ride the host-side ingest plane through a slot remap, so a
        stream's inbox/detector/bookkeeping rows stay glued to its slot."""
        self._arena.apply_remap(remap, new_cap)
        self._detector.apply_remap(remap, new_cap)
        self._slot_sid = remap_rows(self._slot_sid, remap, new_cap, fill=-1)
        self._primed_mask = remap_rows(self._primed_mask, remap, new_cap)
        self._frames_v = remap_rows(self._frames_v, remap, new_cap)
        for s in self._streams.values():
            s.slot = remap[s.slot]
            s.frontend._slot = s.slot
        self._emit_cache = None  # cached rows are indexed by old slots

    def warm(self, capacity: int) -> None:
        self._warm_capacity(capacity)

    def register_model(self, model_id: str, weights, thresholds) -> int:
        raise NotImplementedError(
            "the multi-tenant weight pool is not ported yet: ROADMAP queue "
            "item A.8")

    # -- stream lifecycle ----------------------------------------------------

    def add_stream(self, sid: int | None = None,
                   frontend_cfg: FrontendConfig | None = None,
                   model: str | None = None) -> int:
        """Claim a slot for a new stream (growing the pool if needed);
        returns the stream id."""
        sid = self._next_sid if sid is None else sid
        assert sid not in self._streams, f"stream {sid} already exists"
        if model is not None:
            raise ValueError(
                "model binding needs a tenant pool (max_models > 1)"
            )
        # grow-on-demand alloc (pow-2 doubling to the ceiling) is the
        # pool's; it raises MemoryError when every slot stays busy
        slot = self._slots.alloc(sid)
        self._next_sid = max(self._next_sid, sid) + 1
        self._streams[sid] = _Stream(
            sid=sid,
            slot=slot,
            frontend=AudioFrontend(frontend_cfg, arena=self._arena,
                                   slot=slot),
            events=[],
        )
        self._slot_sid[slot] = sid
        self._detector.reset_slot(slot)
        self._unprimed.add(sid)
        self.metrics.on_join(sid)
        self.obs.events.emit("join", sid=sid, slot=slot, shard=0)
        return sid

    def _require(self, sid: int) -> _Stream:
        s = self._streams.get(sid)
        if s is None:
            live = sorted(self._streams)
            shown = live if len(live) <= 8 else live[:8] + ["..."]
            raise KeyError(
                f"unknown or already-closed stream sid {sid}; "
                f"{len(live)} live sid(s): {shown}"
            )
        return s

    def push_audio(self, sid: int, audio: np.ndarray) -> None:
        s = self._require(sid)
        s.frontend.push(audio)  # arena counts samples_in; folded at close

    def push_audio_batch(self, sids: list[int],
                         chunks: list[np.ndarray]) -> None:
        """Bulk twin of ``push_audio``: one vectorized quantize + scatter
        lands every stream's chunk in the shared arena.  Float PCM and u8
        chunks may be mixed, and a sid may appear multiple times:
        duplicate-sid chunks coalesce in arrival order (float chunks
        pre-quantized with the slot's gain), so the single scatter stays
        bit-identical to sequential pushes."""
        streams = [self._require(sid) for sid in sids]
        slots = np.fromiter((s.slot for s in streams), np.int64, len(streams))
        if np.unique(slots).size != slots.size:
            slots, chunks, extra = self._coalesce_chunks(slots, chunks)
        else:
            extra = None
        self._arena.push_batch(slots, chunks)
        if extra is not None:
            # credit the chunks the coalesce merged away (push_batch
            # counted one per slot) so chunks_in stays arrival-accurate
            self._arena.chunks_in[slots] += extra
            self._arena.total_chunks_in += int(extra.sum())

    def _coalesce_chunks(self, slots: np.ndarray, chunks: list[np.ndarray]
                         ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
        """Merge duplicate-slot chunks into one chunk per slot (arrival
        order preserved); float PCM is quantized here with the slot's
        gain, exactly as ``RingArena.push_batch`` would."""
        merged: dict[int, list[np.ndarray]] = {}
        for slot, chunk in zip(slots.tolist(), chunks):
            c = np.asarray(chunk).reshape(-1)
            if c.dtype.kind == "f":
                c = quantize_pcm(c, self._arena.gain[slot])
            elif c.dtype.kind not in "iu":
                raise TypeError(
                    f"audio must be float PCM or integer u8 codes, "
                    f"got dtype {c.dtype}"
                )
            merged.setdefault(slot, []).append(c)
        out_slots = np.fromiter(merged.keys(), np.int64, len(merged))
        out_chunks = [
            cs[0] if len(cs) == 1 else np.concatenate(cs)
            for cs in merged.values()
        ]
        extra = np.fromiter(
            (len(cs) - 1 for cs in merged.values()), np.int64, len(merged)
        )
        return out_slots, out_chunks, extra

    @property
    def active(self) -> list[int]:
        return sorted(self._streams)

    # -- the batched hop -----------------------------------------------------

    def _prime_ready(self) -> None:
        """Batched mass-join primer: every unprimed stream whose inbox
        holds ``prime_samples`` warms up through ONE vectorized numpy
        advance (``state.prime_batch``) and lands in the slot pool via one
        batched scatter per state tensor."""
        prime = self.plan.prime_samples
        sids = sorted(self._unprimed)
        slots = np.fromiter(
            (self._streams[sid].slot for sid in sids), np.int64, len(sids)
        )
        ready = (self._arena.wr[slots] - self._arena.rd[slots]) >= prime
        if not ready.any():
            return
        t0 = self._clock()
        sids = [sid for sid, r in zip(sids, ready.tolist()) if r]
        slots = slots[ready]
        samples = self._arena.pop_batch(slots, prime)
        # priming consumed a non-hop-multiple; realign the inboxes so
        # every future hop window is one contiguous block
        self._arena.rebase_batch(slots)
        steady = prime_batch(self.plan, self.weights, self.thresholds,
                             samples)
        idx = torch.as_tensor(slots, device=self.device)
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.int32), device=self.device)
        for i in range(len(self.plan.convs)):
            self._tails[i][idx] = put(steady["tails"][i])
            if self._pendings[i].shape[1]:
                self._pendings[i][idx] = put(steady["pendings"][i])
        self._gap[idx] = put(steady["gap"])
        self._frames_v[slots] = steady["frames"]
        self._primed_mask[slots] = True
        for sid in sids:
            s = self._streams[sid]
            s.primed = True
            self._unprimed.discard(sid)
            # host wrote the slot: earlier cached logits don't cover it;
            # the NEXT emit step (which includes this write) does
            s.stamp = self._emit_step + 1
        self.obs.trace.add("prime_batch", t0, self._clock() - t0,
                           n=len(sids))
        self.obs.events.emit("mass_join", n=len(sids))

    def _clear_slot(self, slot: int) -> None:
        for i in range(len(self.plan.convs)):
            self._tails[i][slot] = 0
            if self._pendings[i].shape[1]:
                self._pendings[i][slot] = 0
        self._gap[slot] = 0

    def _host_state(self):
        """One bulk device->host copy of the batched state; per-slot rows
        are then plain numpy indexing."""
        return (
            [t.cpu().numpy() for t in self._tails],
            [p.cpu().numpy() for p in self._pendings],
            self._gap.cpu().numpy(),
        )

    def _extract_slot(self, s: _Stream, host=None) -> StreamState:
        tails, pendings, gap = host if host is not None else self._host_state()
        st = StreamState(self.plan, self.weights, self.thresholds)
        st.import_steady(
            [t[s.slot] for t in tails],
            [p[s.slot] for p in pendings],
            gap[s.slot],
            int(self._frames_v[s.slot]),
        )
        st.samples_seen = s.frontend.samples_in - len(s.frontend)
        return st

    def _hop_barriers(self) -> None:
        """Hop-boundary housekeeping: the pool's rebalance/shrink check
        and the mass-join primer."""
        self._slots.hop_barrier()
        if self._unprimed:
            self._prime_ready()  # numpy warm-up, excluded from step timing

    def _pack_ready(self):
        """Pack stage: consume one hop window from every ready slot.
        Returns ``None`` when no stream is ready, else ``(ready_slots,
        ready_mask, audio, shard_counts, t0, t_pack)``."""
        hop = self.plan.hop_samples
        t0 = self._clock()
        ready_mask = self._primed_mask & self._arena.ready_mask(hop)
        ready_slots = np.nonzero(ready_mask)[0]
        if ready_slots.size == 0:
            return None
        audio = self._arena.pack_hops(ready_slots, hop)
        shard_counts = np.array([ready_slots.size])
        t_pack = self._clock()
        return ready_slots, ready_mask, audio, shard_counts, t0, t_pack

    def _dispatch_hop(self, ready_mask, audio):
        """Dispatch stage: stage operands, run the batched hop, and
        reassign the resident state from its results.  Returns the
        logits/posterior tensors (None with emit off).  The launches the
        hop made are counted through ``kernels.dispatch``."""
        args = (
            torch.as_tensor(audio, device=self.device),
            torch.as_tensor(ready_mask, device=self.device),
            tuple(self._tails), tuple(self._pendings), self._gap,
        )
        n0 = dispatch.count()
        if self.emit_logits:
            tails, pendings, gap, logits, post = self._model.step(
                *args, emit=True
            )
        else:
            tails, pendings, gap = self._model.step(*args, emit=False)
            logits = post = None
        self._last_dispatches = dispatch.count() - n0
        self._tails = list(tails)
        self._pendings = list(pendings)
        self._gap = gap
        return logits, post

    def _fold_hop(self, ready_slots, shard_counts, logits_h, post_h,
                  t0, t_pack, t_dispatch, t_device) -> HopBatch:
        """Fold stage: apply one resolved hop's results to the host-side
        planes — emit cache, frame counters, slot-vectorized detector,
        metrics, lifecycle events, trace spans."""
        if self.emit_logits:
            self._emit_step += 1
            self._emit_cache = logits_h
            self._emit_cache_step = self._emit_step
        self._frames_v[ready_slots] += self.plan.frames_per_hop
        sids = self._slot_sid[ready_slots]
        frames = self._frames_v[ready_slots]
        rows_logits = rows_post = None
        detections: list[Detection] = []
        if self.emit_logits:
            rows_logits = logits_h[ready_slots]
            rows_post = post_h[ready_slots]
            fired, f_cls, f_score = self._detector.update_batch(
                ready_slots, frames, rows_post
            )
            for r, c, sc in zip(fired.tolist(), f_cls.tolist(),
                                f_score.tolist()):
                det = Detection(int(sids[r]), int(c), int(frames[r]),
                                float(sc))
                self._streams[det.stream_id].events.append(det)
                self.metrics.on_detection(det.stream_id)
                self.obs.events.emit("detection", sid=det.stream_id,
                                     cls=det.cls, frame=det.frame,
                                     score=det.score)
                detections.append(det)
        t_detector = self._clock()
        n_disp = self._last_dispatches
        self.metrics.on_step(
            ready_slots.size, self.plan.frames_per_hop,
            t_detector - t0, host_pack_s=t_pack - t0,
            shard_counts=shard_counts.tolist(), finalized=self.emit_logits,
            dispatch_s=t_dispatch - t_pack, device_s=t_device - t_dispatch,
            detector_s=t_detector - t_device, dispatches=n_disp,
        )
        # fold the arena's push-side counters into the metrics at the hop
        # boundary: two scalar reads
        self.metrics.on_push_fold(self._arena.total_samples_in,
                                  self._arena.total_chunks_in)
        t_end = self._clock()
        # hop trace: the stamps are consecutive, so the phase spans tile
        # the hop span exactly; one batched call, B-independent
        n_ready = int(ready_slots.size)
        self.obs.trace.add_batch((
            ("pack", t0, t_pack - t0, {"n": n_ready}),
            ("dispatch", t_pack, t_dispatch - t_pack, {}),
            ("device", t_dispatch, t_device - t_dispatch,
             {"dispatches": n_disp}),
            ("detector", t_device, t_detector - t_device, {}),
            ("push_fold", t_detector, t_end - t_detector, {}),
            ("hop", t0, t_end - t0, {"n": n_ready}),
        ))
        return HopBatch(sids=sids, frames=frames, logits=rows_logits,
                        posteriors=rows_post, detections=detections)

    def step_batch(self) -> HopBatch | None:
        """Advance every stream that has a full hop buffered; None when no
        stream is ready.

        The steady-state hot path, with NO python loop over slots:
        readiness is one vectorized compare over the arena, hop packing is
        one gather, bookkeeping updates are fancy-indexed vector ops, and
        detection advances through the slot-vectorized detector.  The body
        is pack -> dispatch -> fence -> fold.
        """
        self._hop_barriers()
        packed = self._pack_ready()
        if packed is None:
            self._slots.maybe_prewarm()  # starved step = idle; warm the grow
            return None
        ready_slots, ready_mask, audio, shard_counts, t0, t_pack = packed
        logits, post = self._dispatch_hop(ready_mask, audio)
        # the device phase is the explicit fence + transfers: without the
        # fence, wall time would measure the enqueue, not the execution
        t_dispatch = self._clock()
        self._sync()
        logits_h = post_h = None
        if self.emit_logits:
            logits_h = logits.cpu().numpy()  # one bulk transfer per hop
            post_h = post.cpu().numpy()
        t_device = self._clock()
        return self._fold_hop(ready_slots, shard_counts, logits_h, post_h,
                              t0, t_pack, t_dispatch, t_device)

    def _warm_capacity(self, cap: int) -> None:
        """Run the batched step once on zero dummies at ``cap`` slots, so
        the first hop after a grow finds the allocator warm."""
        key = (cap, self.emit_logits)
        if key in self._warmed:
            return
        self._warmed.add(key)
        t0 = self._clock()
        plan = self.plan
        z = self._zeros
        args = (
            z((cap, plan.hop_samples)),
            torch.zeros(cap, dtype=torch.bool, device=self.device),
            tuple(z((cap, st.tail, st.cin)) for st in plan.convs),
            tuple(z((cap, st.phase, st.cout)) for st in plan.convs),
            z((cap, plan.gap_channels)),
        )
        self._model.step(*args, emit=self.emit_logits)
        self._sync()
        self.obs.trace.add("prewarm", t0, self._clock() - t0, capacity=cap)
        self.obs.events.emit("prewarm", capacity=cap)

    def step(self) -> list[tuple[int, int, np.ndarray | None, Detection | None]]:
        """Advance every stream that has a full hop buffered.

        Returns one (sid, frame_idx, logits, detection) tuple per advanced
        stream; logits is None when ``emit_logits`` is off.  A
        compatibility collation of ``step_batch``."""
        return self._collate(self.step_batch())

    @staticmethod
    def _collate(batch: HopBatch | None
                 ) -> list[tuple[int, int, np.ndarray | None,
                                 Detection | None]]:
        if batch is None:
            return []
        det_by_sid = {d.stream_id: d for d in batch.detections}
        if batch.logits is None:
            return [
                (int(sid), int(fr), None, None)
                for sid, fr in zip(batch.sids.tolist(), batch.frames.tolist())
            ]
        return [
            (int(sid), int(fr), batch.logits[r].copy(), det_by_sid.get(sid))
            for r, (sid, fr) in enumerate(
                zip(batch.sids.tolist(), batch.frames.tolist())
            )
        ]

    def run_until_starved(self) -> list[tuple[int, int, np.ndarray | None,
                                              Detection | None]]:
        """Step until no stream has a full hop buffered."""
        out = []
        while True:
            r = self.step()
            if not r:
                return out
            out.extend(r)

    def drain(self) -> int:
        """Run ``step_batch`` until starved; returns hops executed."""
        hops = 0
        while self.step_batch() is not None:
            hops += 1
        return hops

    # -- inspection / teardown ----------------------------------------------

    def peek(self, sid: int) -> np.ndarray:
        """Finalized logits if the stream ended now (inbox included) —
        bit-exact with the offline executor on the audio pushed so far.

        On a hop boundary (empty inbox) this reads the last emit step's
        cached logits, or runs the finalization (one finalize launch on
        the megakernel backend, ``dispatches_per_finalize`` launches on the
        per-stage backend) when no emit covers this slot yet; with
        leftover sub-hop samples it drops to the exact numpy fallback
        (``StreamState.peek_logits``)."""
        s = self._require(sid)
        if s.primed and len(s.frontend) == 0:
            if (self._emit_cache is not None
                    and s.stamp <= self._emit_cache_step):
                return self._emit_cache[s.slot].copy()
            logits, _ = self._model.finalize(
                tuple(self._tails), tuple(self._pendings), self._gap)
            return logits[s.slot].cpu().numpy()
        return self._peek_fallback(s)

    def _peek_fallback(self, s: _Stream) -> np.ndarray:
        if s.primed:
            st = self._extract_slot(s)
        else:
            st = StreamState(self.plan, self.weights, self.thresholds)
        leftover = s.frontend.peek_all() if len(s.frontend) else None
        return st.peek_logits(leftover)

    def close_stream(self, sid: int) -> StreamResult:
        """Flush (right-pad + drop incomplete pools), free the slot, and
        shrink the pool once occupancy drops to a quarter."""
        s = self._require(sid)
        del self._streams[sid]
        self._unprimed.discard(sid)
        samples_in = s.frontend.samples_in
        chunks_in = s.frontend.chunks_in
        if s.primed:
            st = self._extract_slot(s)
        else:
            st = StreamState(self.plan, self.weights, self.thresholds)
        st.advance(s.frontend.pop_all(), flush=True)
        logits = st.logits()
        # one last detector update with the flushed logits (host softmax),
        # through the same slot-vectorized state machine the hops drove
        fired, f_cls, f_score = self._detector.update_batch(
            np.array([s.slot], np.int64), np.array([st.frames], np.int64),
            _softmax(logits)[None, :],
        )
        if fired.size:
            det = Detection(sid, int(f_cls[0]), st.frames, float(f_score[0]))
            s.events.append(det)
            self.metrics.on_detection(sid)
        self._slots.free(s.slot)
        self._clear_slot(s.slot)  # scrub so the next tenant starts clean
        self._arena.clear_slot(s.slot)
        self._detector.reset_slot(s.slot)
        self._slot_sid[s.slot] = -1
        self._primed_mask[s.slot] = False
        self._frames_v[s.slot] = 0
        self.metrics.on_close(sid, frames_out=st.frames,
                              samples_in=samples_in, chunks_in=chunks_in)
        self.obs.events.emit("close", sid=sid, frames=st.frames,
                             samples=samples_in, events=len(s.events))
        # the shrink runs now so an emptying pool releases capacity
        # without needing another hop
        self._slots.maybe_shrink()
        return StreamResult(
            stream_id=sid,
            logits=logits,
            frames=st.frames,
            samples=st.samples_seen,
            events=list(s.events),
        )
