"""Continuous-batching multi-stream scheduler for always-on KWS (PyTorch).

The port of the reference's ``repro/stream/scheduler.py``.
Thousands of concurrent audio streams each produce frames continuously;
the model weights are shared across all of them.  The scheduler packs
the active streams onto an *elastic* batch axis and advances them with ONE
batched step per hop:

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
    (``kernels/conv_kernels.py``).  Chosen only when asked for.
  * ``"torch"``: the dense twin of the reference's ``"jnp"`` backend —
    plain tensor ops, integer contractions in float64 (exact here: every
    accumulator is far below 2^53), no hand-written kernel.

Per emit hop the step also returns every slot's finalized logits — the
exact logits the offline executor would produce if the utterance ended at
this hop — and softmax posteriors.  ``StreamState.peek_logits`` (numpy)
stays the exact fallback for peeks over leftover sub-hop samples.

**Staging.**  A hop's operands (audio, mask, tenant rows) go to the card
from pinned host buffers and its logits and posteriors come back into
pinned ones, every copy ``non_blocking`` on the CUDA stream the kernels
run on, and the events recorded after the last copies, one per device,
are the hop's fence.  So dispatching a hop never waits on the device, which lets the
async plane (``stream/async_plane.py``) enqueue hop N+1 while hop N runs.
With ``donate_buffers`` the megakernel writes each hop's state into a
second resident state set, and the two swap every hop (the paper's
ping-pong feature SRAM): a steady hop allocates no state tensor.

**Tenant pool.**  With ``max_models > 1`` the weights are ``(K, ...)``
stacks, raw and laid out for every kernel; each stream binds a registered
variant (``register_model``, ``add_stream(model=...)``; LRU eviction in
``WeightPool``), placement keeps every ``tenant_block`` of slots
single-model, and every kernel takes a per-slot model index, so a hop
makes the same launches for any K.

**Mesh sharding (one pool, S shards).**  Pass ``mesh`` (see
``launch.mesh.make_stream_mesh``) and the slot pool splits into S
contiguous per-shard row blocks: shard ``s``'s rows of every batched
state tensor (tails, pendings, GAP, model rows, the emit logits, the
donated spare set) are a tensor of their own on ``mesh.devices[s]`` (a
``launch.mesh.ShardRows``), whether the shards share one device or each
has a card.  ``SlotPlacement`` puts a joining stream on the least-loaded
shard and resizes per shard; the weights and every layout of them lie
once on each distinct device (``_ShardedModel``); every kernel launch of
a hop is issued once per shard on that shard's rows, under its device
(the port of the reference's ``shard_map`` launches); the host stages
each shard's operands to its device and gathers each shard's logits back
in slot order, with one event per device.  At hop barriers a
cross-shard rebalance migrates rows when leave churn skews the shards
(``SlotPool.hop_barrier``), each row read from its source shard's
device.  A sharded run is bit-exact with the single-device scheduler,
stream for stream.  With no mesh or one shard every path is the
single-device one.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cnn_spec import CNN1DSpec
from repro_torch.kernels import conv_kernels, dispatch, ops
from repro_torch.kernels.hop_megakernel import prepare_hop_weights
from repro_torch.launch.mesh import (
    ShardRows,
    canonical_device,
    current,
    dp_size,
)
from repro_torch.obs import Observability
from repro_torch.runtime.pool import SlotPool, tree_map
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

#: pool row 0 always holds the scheduler's construction weights
DEFAULT_MODEL = "default"

#: the children of ``push_audio_batch``'s ``push`` span, back to back:
#: sids to slots (and the coalesce), the arena's flatten / check /
#: quantize, the landing coordinates and the landing with the counters.
#: On ``RingArena.push_batch``'s block path the coordinates are one block
#: index a row and the landing one block-row assignment; on its flat path
#: they are index arrays of one entry a sample and a per-sample scatter.
PUSH_PHASES = ("push.resolve", "push.stage", "push.index", "push.scatter")
#: the children of ``add_stream``'s ``join`` span, back to back
JOIN_PHASES = ("join.alloc", "join.frontend", "join.detector",
               "join.record")

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
    thresholds, bool conv flips, int32 fc weights and flips; and
    ``"hop"``, the same weights in int8 laid out once for the CUDA hop
    kernel (``kernels.hop_megakernel.prepare_hop_weights``).
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
    prep["hop"] = prepare_hop_weights(
        tuple(w.to(torch.int8) for w in prep["w"]),
        tuple(w.to(torch.int8) for w in prep["fc_w"]))
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


class WeightPool:
    """K complete model variants sharing one plan geometry (the host
    side: the device stacks lie once on each device of the pool).

    The pool owns the *host* side of multi-tenancy: which model ids are
    resident, which pool row (0..max_models-1) each occupies, how many
    live streams pin each variant, and LRU admission/eviction.  Row
    indices are stable for a variant's whole residency and the row count
    is FIXED at ``max_models`` from construction, so the device-side
    ``(K, ...)`` weight stacks never change shape — admission is a row
    write.

    Row 0 conventionally holds the scheduler's default model
    (``DEFAULT_MODEL``), admitted at construction and never evicted
    while default-bound streams exist (refcounting covers it like any
    other variant).
    """

    def __init__(self, max_models: int) -> None:
        if max_models < 1:
            raise ValueError(f"max_models must be >= 1, got {max_models}")
        self.max_models = max_models
        self._index: dict[str, int] = {}
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self._weights: dict[str, dict] = {}
        self._thresholds: dict[str, dict] = {}
        self._refs: dict[str, int] = {}
        self._free = list(range(max_models - 1, -1, -1))  # pop() -> row 0
        self.admits = 0
        self.evictions = 0

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._index

    def __len__(self) -> int:
        return len(self._index)

    def models(self) -> list[tuple[str, int]]:
        """Resident variants as ``(model_id, pool row)``, row order."""
        return sorted(self._index.items(), key=lambda kv: kv[1])

    def index_of(self, model_id: str) -> int:
        return self._index[model_id]

    def refcount(self, model_id: str) -> int:
        return self._refs[model_id]

    def params_for(self, model_id: str):
        """The pool-held (weights, thresholds) host copies."""
        return self._weights[model_id], self._thresholds[model_id]

    def admit(self, model_id: str, weights, thresholds
              ) -> tuple[int, str | None]:
        """Bind a variant to a pool row; returns ``(row, evicted_id)``.

        A resident id is an LRU touch (its stored params stay — the
        caller re-registers, the pool does not re-copy).  When full, the
        least-recently-used variant with NO live streams is evicted; if
        every row is pinned, MemoryError.
        """
        if model_id in self._index:
            self._lru.move_to_end(model_id)
            return self._index[model_id], None
        evicted = None
        if self._free:
            row = self._free.pop()
        else:
            victim = next(
                (m for m in self._lru if self._refs[m] == 0), None
            )
            if victim is None:
                raise MemoryError(
                    f"weight pool full: all {self.max_models} variants "
                    "have live streams; close streams or raise max_models"
                )
            row = self._evict(victim)
            evicted = victim
            self.evictions += 1
        # store the caller's mappings as-is: the memoized prep
        # (prepared_model_params) keys on their identity, so re-admitting
        # the same arrays — here or in another scheduler — never re-lays
        # them out
        self._weights[model_id] = weights
        self._thresholds[model_id] = thresholds
        self._index[model_id] = row
        self._refs[model_id] = 0
        self._lru[model_id] = None
        self.admits += 1
        return row, evicted

    def _evict(self, model_id: str) -> int:
        row = self._index.pop(model_id)
        del self._weights[model_id]
        del self._thresholds[model_id]
        del self._refs[model_id]
        del self._lru[model_id]
        return row

    def acquire(self, model_id: str) -> int:
        """Pin a variant for one joining stream; returns its row."""
        self._refs[model_id] += 1
        self._lru.move_to_end(model_id)
        return self._index[model_id]

    def release(self, model_id: str) -> None:
        if self._refs[model_id] < 1:
            raise ValueError(f"model {model_id!r} has no live stream")
        self._refs[model_id] -= 1


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
    model: str = DEFAULT_MODEL  # tenant variant this stream computes with


@dataclasses.dataclass
class _Dispatched:
    """One dispatched hop's results on their way to the host: the host
    tensors its logits and posteriors land in (None with emit off), the
    events recorded after their copies, one per device the hop ran on
    (none on the CPU, where nothing is in flight), and the kernel
    launches the hop made."""

    logits: torch.Tensor | None
    post: torch.Tensor | None
    events: tuple[torch.cuda.Event, ...]
    dispatches: int


class _HostStaging:
    """The host side of a hop's copies: a ring of ``n`` slots of pinned
    buffers, one per operand or result name, made at the shape asked for
    (so a resize reallocates them).  Every copy is ``non_blocking`` on the
    current CUDA stream of its device, and the events recorded after a
    hop's copies, one per device, guard its slot: before the host
    rewrites a slot's buffers it waits on them, which have always passed
    by then when ``n`` exceeds the hops in flight.

    With ``mesh`` (S >= 2 shards) an operand leaves as a ``ShardRows``:
    shard ``s``'s rows are copied from their slice of the one pinned
    buffer to ``mesh.devices[s]``; a result comes back shard by shard
    into its rows of one pinned buffer, so the host reads the pool's rows
    in slot order.  On the CPU there is nothing to stage: operands are
    plain tensors (split into shards) and results are read in place."""

    def __init__(self, device: torch.device, n: int, mesh=None) -> None:
        self.device = device
        self.mesh = mesh
        self._devices = (device,) if mesh is None else mesh.distinct
        self._bufs: list[dict[str, torch.Tensor]] = [{} for _ in range(n)]
        self._events: list[tuple] = [()] * n
        self._i = n - 1

    def next(self) -> int:
        """Claim the next slot of the ring, once its last copies are done."""
        self._i = (self._i + 1) % len(self._bufs)
        for ev in self._events[self._i]:
            if not ev.query():
                ev.synchronize()
        self._events[self._i] = ()
        return self._i

    def _buffer(self, i: int, name: str, shape, dtype) -> torch.Tensor:
        buf = self._bufs[i].get(name)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._bufs[i][name] = buf
        return buf

    def to_device(self, i: int, name: str, a: np.ndarray):
        """Slot ``i``'s copy of the host array ``a`` on the device (a
        ``ShardRows`` over the mesh's shards)."""
        if self.device.type == "cpu":
            return torch.tensor(a) if self.mesh is None else \
                self.mesh.split(a)
        src = torch.from_numpy(np.ascontiguousarray(a))
        buf = self._buffer(i, name, src.shape, src.dtype)
        buf.copy_(src)
        if self.mesh is None:
            return buf.to(self.device, non_blocking=True)
        n = buf.shape[0] // len(self.mesh.devices)
        return ShardRows(buf[s * n:(s + 1) * n].to(d, non_blocking=True)
                         for s, d in enumerate(self.mesh.devices))

    def to_host(self, i: int, name: str, t) -> torch.Tensor:
        """Slot ``i``'s host tensor that ``t`` (a ``ShardRows`` over the
        mesh's shards) lands in, rows in slot order (``t`` itself on the
        CPU); readable once the slot's events have passed."""
        if self.device.type == "cpu":
            return t if self.mesh is None else t.cpu()
        buf = self._buffer(i, name, t.shape, t.dtype)
        if self.mesh is None:
            buf.copy_(t, non_blocking=True)
            return buf
        n = t.parts[0].shape[0]
        for s, part in enumerate(t.parts):
            buf[s * n:(s + 1) * n].copy_(part, non_blocking=True)
        return buf

    def record(self, i: int) -> tuple[torch.cuda.Event, ...]:
        """The events after slot ``i``'s copies, one per device (none on
        the CPU)."""
        if self.device.type == "cpu":
            return ()
        evs = []
        for d in self._devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            evs.append(ev)
        self._events[i] = tuple(evs)
        return self._events[i]


def _empty_like(x):
    """An uninitialised tensor (or ``ShardRows``) shaped like ``x``."""
    if isinstance(x, ShardRows):
        return x.map(torch.empty_like)
    return torch.empty_like(x)


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
    so the elastic slot pool needs nothing per capacity.  Over a mesh,
    :class:`_ShardedModel` runs one of these per device on each shard's
    rows.

    With ``pool_size`` (a tenant pool) axis 0 of every weight operand
    stacks K complete variants — raw and in every kernel's layout — and
    the hop takes a per-slot ``model_idx``.  Unfilled rows hold the
    default model, so the stack SHAPES are fixed from construction:
    admitting a variant is a row write (``set_model_row``).
    """

    def __init__(self, plan: StreamPlan, backend: str, params: dict,
                 pool_size: int | None = None,
                 tenant_block: int = 8) -> None:
        self.plan = plan
        self.backend = backend
        self.pool_size = pool_size
        self._tenant_block = tenant_block
        if pool_size is None:
            stack = lambda t: t  # noqa: E731
        else:
            stack = lambda t: torch.stack([t] * pool_size)  # noqa: E731
        self._w = [stack(w) for w in params["w"]]
        self._thr = [stack(t) for t in params["thr"]]
        self._flip = [stack(f) for f in params["flip"]]
        self._fc_w = tuple(stack(w) for w in params["fc_w"])
        self._fc_thr = tuple(stack(t) for t in params["fc_thr"])
        self._fc_flip = tuple(stack(f) for f in params["fc_flip"])
        self._fc_raw = tuple(st.out_raw for st in plan.fcs)
        if backend == "megakernel":
            # the kernel's operands, prepared once: int8 weights laid out
            # for its tensor-core GEMMs (carrying the fc weights too),
            # int32 flips
            self._kw = params["hop"] if pool_size is None else \
                prepare_hop_weights(
                    tuple(w.to(torch.int8) for w in self._w),
                    tuple(w.to(torch.int8) for w in self._fc_w))
            self._kflip = tuple(f.to(torch.int32) for f in self._flip)
            self._kfc_w = self._kw.fc_ws
        elif backend == "per_stage":
            # the per-stage kernels' operands, prepared once: int8
            # weights, packed pos/neg planes (laid out for B.4's tensor
            # cores on the binary stages) and sum(w) per conv layer, the
            # int8 fc weights laid out for B.5's (thresholds are float32
            # and fc flips int32 in the prepared params already)
            self._cw = tuple(ops.conv_weights(w, layout=st.in_bits == 1)
                             for w, st in zip(self._w, plan.convs))
            self._kfc_w = conv_kernels.prepare_tail_weights(
                w.to(torch.int8) for w in self._fc_w)

    # -- tenant pool device side ---------------------------------------------

    def set_model_row(self, idx: int, params: dict) -> None:
        """Write one tenant's prepared params (``prepared_model_params``,
        same plan) into pool row ``idx`` of every stack: the raw weights,
        thresholds and flips, and every layout made from them — the hop
        kernel's ``HopWeights`` and int32 flips, or the per-stage
        ``ConvWeights`` and B.5's ``TailWeights``.  A layout that missed
        the write would run the evicted model's bits."""
        if self.pool_size is None or not 0 <= idx < self.pool_size:
            raise ValueError(f"pool row {idx} of {self.pool_size}")

        def put(dsts, srcs):
            for dst, src in zip(dsts, srcs):
                dst[idx].copy_(src)

        put(self._w, params["w"])
        put(self._thr, params["thr"])
        put(self._flip, params["flip"])
        put(self._fc_w, params["fc_w"])
        put(self._fc_thr, params["fc_thr"])
        put(self._fc_flip, params["fc_flip"])
        if self.backend == "megakernel":
            kw, one = self._kw, params["hop"]
            for name in ("ws", "fc_ws", "conv", "wsum", "fc"):
                put(getattr(kw, name), getattr(one, name))
            put(self._kflip, params["flip"])
        elif self.backend == "per_stage":
            for cw, w, st in zip(self._cw, params["w"], self.plan.convs):
                one = ops.conv_weights(w, layout=st.in_bits == 1)
                for f in dataclasses.fields(cw):
                    if getattr(cw, f.name) is not None:
                        getattr(cw, f.name)[idx].copy_(getattr(one, f.name))
            one = conv_kernels.prepare_tail_weights(
                w.to(torch.int8) for w in params["fc_w"])
            put(self._kfc_w.ws, one.ws)
            put(self._kfc_w.frag, one.frag)

    def _bb(self, b: int) -> int | None:
        """Tenant-aligned slot block of a batch of ``b`` rows (one shard's
        over a mesh): placement keeps each ``min(tenant_block,
        shard_capacity)`` block single-model, so each of the kernels'
        blocks gathers one weight row.  None when un-pooled."""
        if self.pool_size is None:
            return None
        return min(self._tenant_block, max(1, b))

    def _block_gather(self, stack: torch.Tensor, model_idx: torch.Tensor
                      ) -> tuple[torch.Tensor, int]:
        """One weight row per tenant block instead of per slot: the dense
        backend's twin of the kernels' per-block gather, exact because
        the contractions are integer."""
        tb = self._bb(model_idx.shape[0])
        return stack[model_idx.reshape(-1, tb)[:, 0].long()], tb

    # -- shared conv math (dense and per-stage backends) --------------------

    @staticmethod
    def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact integer contraction through float64 (CUDA has no int32
        GEMM; every partial sum here is far below 2^53)."""
        return torch.einsum(eq, a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)

    def _conv_raw(self, i: int, window: torch.Tensor, n_conv: int,
                  model_idx: torch.Tensor | None = None) -> torch.Tensor:
        """(B, len, Cin) window -> (B, n_conv, Cout) raw conv: one B.3
        or B.4 launch on the per-stage backend, a dense contraction on the
        torch backend.  With ``model_idx`` the weights are the pooled
        stacks, one row per tenant block."""
        st = self.plan.convs[i]
        if self.backend == "per_stage":
            bb = self._bb(window.shape[0])
            if st.in_bits > 1:
                return ops.bitserial_conv1d_batched(
                    window, self._cw[i], model_idx, bits=st.in_bits,
                    offset=st.in_offset, stride=st.stride, bb=bb)
            return ops.bnn_conv1d_batched(
                window, self._cw[i], None, None, model_idx,
                stride=st.stride, mode="raw", bb=bb)
        x = window - st.in_offset if st.in_bits > 1 else window
        taps = [
            x[:, t : t + (n_conv - 1) * st.stride + 1 : st.stride]
            for t in range(st.k)
        ]
        xs = torch.stack(taps, 1)
        if model_idx is None:
            return self._contract("bknc,kco->bno", xs, self._w[i])
        wg, tb = self._block_gather(self._w[i], model_idx)
        xg = xs.reshape(-1, tb, *xs.shape[1:])
        return self._contract("gtknc,gkco->gtno", xg, wg).reshape(
            xs.shape[0], n_conv, -1)

    def _sa(self, i: int, raw: torch.Tensor,
            model_idx: torch.Tensor | None = None) -> torch.Tensor:
        """SA binarization, executor-exact: integer thresholds make the
        float32 compare knife-edge free."""
        thr, flip = self._thr[i], self._flip[i]
        if model_idx is not None:
            thr, flip = thr[model_idx][:, None, :], flip[model_idx][:, None, :]
        ge = raw.to(torch.float32) >= thr
        return torch.where(flip, ~ge, ge).to(torch.int32)

    # -- the hop -------------------------------------------------------------

    def step(self, audio, mask, tails, pendings, gap, model_idx=None, *,
             emit: bool, out=None):
        """One batched hop; with ``emit`` also per-slot finalized logits +
        posteriors.  ``mask`` (B,) bool selects the slots that advance;
        ``model_idx`` ((B,) int32, pooled models only) each slot's tenant
        row, constant per tenant block, so the launches do not depend on
        K.  ``out`` (megakernel only) is a state set the kernel writes
        the new state into."""
        plan = self.plan
        stages = plan.convs
        cur = audio.reshape(audio.shape[0], plan.hop_samples, stages[0].cin)
        if self.backend == "megakernel":
            out = ops.hop_megakernel(
                cur, mask.to(torch.int32), tuple(tails), tuple(pendings),
                gap, self._kw, self._thr, self._kflip, self._kfc_w,
                self._fc_thr, self._fc_flip, model_idx, stages=stages,
                emit=emit, fc_raw=self._fc_raw, bb=self._bb(gap.shape[0]),
                out=out,
            )
            state = out[0], out[1], out[2]
            if not emit:
                return state
            logits = out[3]
            return (*state, logits, torch.softmax(logits.float(), -1))
        new_tails, new_pendings = [], []
        for i, st in enumerate(stages):
            window = torch.cat([tails[i], cur], 1)
            raw = self._conv_raw(i, window, st.n_conv, model_idx)
            new_tails.append(window[:, st.n_conv * st.stride :])
            y = self._sa(i, raw, model_idx)
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
        logits, post = self.finalize(*state, model_idx)
        return (*state, logits, post)

    # -- finalization tail ---------------------------------------------------

    def finalize(self, tails, pendings, gap, model_idx=None):
        """Logits/posteriors as if every stream ended at this hop boundary:
        a ghost end-of-stream flush sized by the plan's ``flush_*``
        geometry, then the fc classifier on the saturated GAP counts."""
        if self.backend == "megakernel":
            logits = ops.finalize_megakernel(
                tuple(tails), tuple(pendings), gap, self._kw, self._thr,
                self._kflip, self._kfc_w, self._fc_thr, self._fc_flip,
                model_idx, stages=self.plan.convs, fc_raw=self._fc_raw,
                bb=self._bb(gap.shape[0]),
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
                y = self._sa(i, self._conv_raw(i, window, st.flush_conv,
                                               model_idx), model_idx)
            else:
                y = torch.zeros((B, 0, st.cout), dtype=torch.int32,
                                device=gap.device)
            frames = torch.cat([pendings[i], y], 1)
            used = st.flush_out * st.pool  # drop-remainder (ref_maxpool1d)
            cur = frames[:, :used].reshape(
                B, st.flush_out, st.pool, st.cout
            ).amax(2)
        gap_f = torch.clamp(gap + cur.sum(1, dtype=torch.int32), max=255)
        logits = self._classifier(gap_f, model_idx)
        return logits, torch.softmax(logits.float(), -1)

    def _classifier(self, gap_f: torch.Tensor,
                    model_idx: torch.Tensor | None = None) -> torch.Tensor:
        """Saturated GAP counts (B, C) -> raw logits (B, n_classes)."""
        if self.backend == "per_stage":
            return ops.classifier_tail(
                gap_f, self._kfc_w, self._fc_thr, self._fc_flip, model_idx,
                out_raw=self._fc_raw, bb=self._bb(gap_f.shape[0]))
        h = gap_f
        for j, st in enumerate(self.plan.fcs):
            thr, flip = self._fc_thr[j], self._fc_flip[j]
            if model_idx is None:
                raw = self._contract("bc,co->bo", h, self._fc_w[j])
            else:
                wg, tb = self._block_gather(self._fc_w[j], model_idx)
                raw = self._contract("gtc,gco->gto",
                                     h.reshape(-1, tb, h.shape[1]),
                                     wg).reshape(h.shape[0], -1)
                thr, flip = thr[model_idx], flip[model_idx]
            if st.out_raw:
                h = raw
            else:
                ge = raw.to(torch.float32) >= thr
                h = torch.where(flip != 0, ~ge, ge).to(torch.int32)
        return h

    def dispatches_per_hop(self, emit: bool) -> int:
        """Hand-written kernel launches one hop makes per shard, as the
        reference counts them: 1 for the megakernel (emit's flush +
        classifier ride the same launch), 0 for the dense backend, and for
        the per-stage backend one per conv stage plus, on emit, a
        finalization's launches.  The scheduler counts the real launches
        of every hop through ``kernels.dispatch``, S times this over S
        shards (:class:`_ShardedModel`), and the tests hold the two to
        that."""
        if self.backend == "per_stage":
            n = len(self.plan.convs)
            return n + (self.dispatches_per_finalize() if emit else 0)
        return 1 if self.backend == "megakernel" else 0

    def dispatches_per_finalize(self) -> int:
        """Launches of one standalone finalization (a hop-boundary peek no
        emit covers) per shard: 1 for the megakernel, 0 for the dense
        backend, and for the per-stage backend one per ghost-flush conv
        with ``flush_conv > 0`` plus the classifier tail."""
        if self.backend == "per_stage":
            return sum(1 for st in self.plan.convs if st.flush_conv > 0) + 1
        return 1 if self.backend == "megakernel" else 0


def _part(tree, s: int):
    """Shard ``s``'s part of every ``ShardRows`` in a nested tuple or
    list (None stays None)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_part(t, s) for t in tree)
    return None if tree is None else tree.parts[s]


def _join(results):
    """Per-shard results (nested tuples of tensors, alike) -> one nested
    tuple of ``ShardRows``."""
    first = results[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_join(xs) for xs in zip(*results))
    return ShardRows(results)


class _ShardedModel:
    """The hop over the S >= 2 shards of a mesh.

    Shard ``s``'s rows, the parts of ``ShardRows`` on ``mesh.devices[s]``,
    run the :class:`_BatchedModel` of that device: the weights, thresholds
    and every layout of them (``HopWeights``, ``ConvWeights``,
    ``TailWeights``, a tenant pool's stacks) are made once per distinct
    device and shared by the shards on it.  Each shard's step runs with
    its device current, so each kernel launch of a hop is made once per
    shard, on its device's current stream, as the reference's
    ``shard_map`` makes one per device, and the dense and per-stage
    backends' glue (window concat, SA, pool, GAP, mask merge) runs on
    each shard's tensors without a device switch around every op.  Placement keeps every tenant
    block inside one shard.  Same surface as :class:`_BatchedModel`, but
    ``set_model_row`` takes a function from a device to the prepared
    params on it."""

    def __init__(self, plan: StreamPlan, backend: str, params_on, mesh,
                 pool_size: int | None = None,
                 tenant_block: int = 8) -> None:
        self.plan = plan
        self.backend = backend
        self.pool_size = pool_size
        self.models = {d: _BatchedModel(plan, backend, params_on(d),
                                        pool_size, tenant_block)
                       for d in mesh.distinct}
        self._devices = mesh.devices
        self._shards = [self.models[d] for d in mesh.devices]

    def set_model_row(self, idx: int, params_on) -> None:
        """Write one tenant into pool row ``idx`` on every device."""
        for d, m in self.models.items():
            m.set_model_row(idx, params_on(d))

    def step(self, *args, emit: bool, out=None):
        """:meth:`_BatchedModel.step` on every shard's rows; the state
        (and logits and posteriors) come back as ``ShardRows``, written
        into ``out``'s parts when given."""
        results = []
        for s, (d, m) in enumerate(zip(self._devices, self._shards)):
            with current(d):
                results.append(m.step(*_part(args, s), emit=emit,
                                      out=_part(out, s)))
        return _join(results)

    def finalize(self, *args):
        """:meth:`_BatchedModel.finalize` on every shard's rows."""
        results = []
        for s, (d, m) in enumerate(zip(self._devices, self._shards)):
            with current(d):
                results.append(m.finalize(*_part(args, s)))
        return _join(results)

    def dispatches_per_hop(self, emit: bool) -> int:
        return self._shards[0].dispatches_per_hop(emit)

    def dispatches_per_finalize(self) -> int:
        return self._shards[0].dispatches_per_finalize()


class StreamScheduler:
    """Continuous batching over an elastic pool of stream slots.

    ``capacity`` is the *ceiling*: the pool starts at ``initial_capacity``
    (default ``min_capacity``) and doubles on demand up to the ceiling;
    ``close_stream`` halves it once occupancy falls to a quarter (never
    below ``min_capacity`` — set ``min_capacity == capacity`` to pin a
    fixed-size pool).  Each resize is a pure pad/slice of the batched ring
    state, so a stream fed across a resize boundary produces bit-identical
    logits to one fed at a fixed capacity.

    Takes the reference's constructor arguments plus ``device`` (default:
    the device of the mesh's shard 0, else ``"cuda"``; raises when CUDA
    is absent, never continues on the CPU).
    ``interpret`` has no meaning here (there is no interpret mode) and is
    accepted for signature parity.  ``max_models > 1`` turns on the tenant
    weight pool (``register_model``, ``add_stream(model=...)``), whose
    slot blocks of ``tenant_block`` (a power of two) stay single-model.
    ``donate_buffers`` makes the megakernel write each hop's state into a
    second resident state set, the two swapping every hop; on the
    ``torch`` and ``per_stage`` backends it is accepted and changes
    nothing.

    ``mesh`` (``launch.mesh.make_stream_mesh``) spreads the pool over
    its S shards, on one device or on several cards: every capacity must
    be a multiple of S (``ValueError``), shard ``s``'s rows lie on
    ``mesh.devices[s]``, a joining stream lands on the least-loaded shard,
    resizes scale the per-shard capacity, leave churn that skews the
    shards is levelled by a migration at the next hop barrier, and each
    hop makes its kernel launches once per shard on the shard's rows,
    under its device.
    """

    #: hops the scheduler keeps in flight (the async plane raises it); the
    #: host staging ring holds one slot more
    _pipeline_depth = 0

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
        device=None,
    ) -> None:
        if backend == "pallas":
            raise ValueError(
                "backend='pallas' names the reference's TPU kernels; the "
                "port's per-stage kernel backend is 'per_stage'")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        n_shards = 1
        if mesh is not None:
            mesh_device = mesh.devices[0]
            n_shards = dp_size(mesh)
            if device is None:
                device = mesh_device
            elif torch.device(device).type != mesh_device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh_device}")
        for name, cap in (("capacity", capacity),
                          ("initial_capacity", initial_capacity),
                          ("min_capacity", min_capacity)):
            if cap is not None and cap % n_shards:
                raise ValueError(f"{name} {cap} is not a multiple of the "
                                 f"mesh's {n_shards} shards")
        if max_models < 1:
            raise ValueError(f"max_models must be >= 1, got {max_models}")
        if max_models > 1 and (tenant_block < 1
                               or tenant_block & (tenant_block - 1)):
            raise ValueError(f"tenant_block {tenant_block} is not a power "
                             "of two")
        self.device = _require_device("cuda" if device is None else device)
        if mesh is not None and canonical_device(self.device) != mesh_device:
            raise ValueError(f"device {self.device} is not the mesh's "
                             f"device {mesh_device}")
        self.mesh = mesh
        self.n_shards = n_shards
        # S >= 2: every batched state tensor is a ShardRows over the mesh
        self._mesh = mesh if n_shards > 1 else None
        #: the devices the pool's rows lie on, each once
        self.devices = ((self.device,) if self._mesh is None
                        else self._mesh.distinct)
        self._clock = clock
        self.plan = plan_stream(spec, hop_frames=hop_frames)
        self.weights = {k: np.asarray(v) for k, v in weights.items()}
        self.thresholds = thresholds
        self.backend = backend
        self.detector_cfg = detector_cfg or DetectorConfig()
        self.emit_logits = emit_logits
        self.obs = obs if obs is not None else Observability.create()
        self.metrics = StreamMetrics(self.plan, sample_rate,
                                     n_shards=n_shards,
                                     registry=self.obs.registry)
        # tenant weight pool: with max_models > 1 the device weights are
        # (K, ...) stacks and each stream binds a registered variant at
        # join time; row 0 always holds the construction weights
        self._pool = WeightPool(max_models) if max_models > 1 else None
        self._tenant_block = tenant_block
        if self._pool is not None:
            self._pool.admit(DEFAULT_MODEL, self.weights, self.thresholds)
        pool_size = max_models if self._pool is not None else None
        if self._mesh is None:
            self._model = _BatchedModel(
                self.plan, backend, prepared_model_params(
                    self.plan, weights, thresholds, self.device),
                pool_size=pool_size, tenant_block=tenant_block)
        else:
            self._model = _ShardedModel(
                self.plan, backend, lambda d: prepared_model_params(
                    self.plan, weights, thresholds, d), self._mesh,
                pool_size=pool_size, tenant_block=tenant_block)
        # the generic slot-pool plane: slot<->sid binding, pow-2 elastic
        # resize, idle-time prewarm, resize observability.  This scheduler
        # is its client through device_state/slot_axes/shard/
        # apply_host_remap below.
        self._slots = SlotPool(
            self, capacity,
            initial_capacity=initial_capacity,
            min_capacity=min_capacity,
            n_shards=n_shards,
            tenant_block=tenant_block if self._pool is not None else None,
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
        # donated state: the spare set the next hop writes (made at the
        # current capacity on first use, dropped on every remap)
        self._donate = donate_buffers and backend == "megakernel"
        self._spare = None
        self._staging = _HostStaging(self.device, self._pipeline_depth + 1,
                                     self._mesh)
        base_inbox = (
            inbox_samples if inbox_samples is not None
            else FrontendConfig().capacity_samples
        )
        # whole hops only: keeps primed slots on the block-aligned paths
        # of pack_hops and push_batch (see RingArena.rebase)
        hop = self.plan.hop_samples
        self._inbox_samples = -(-base_inbox // hop) * hop
        self._arena = RingArena(cap0, self._inbox_samples)
        self._detector = BatchedDetector(
            cap0, self.plan.fcs[-1].cout, self.detector_cfg
        )
        self._slot_sid = np.full(cap0, -1, np.int64)
        self._primed_mask = np.zeros(cap0, bool)
        self._frames_v = np.zeros(cap0, np.int64)  # frames per slot
        # per-slot tenant rows (pool row 0 = default model); staged to the
        # device when they change, remapped with every resize like the
        # other slot-indexed vectors
        self._model_idx_v = np.zeros(cap0, np.int32)
        self._model_rows_dirty = False
        self._model_idx_dev = None  # the device copy of the rows
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

    def _zeros(self, shape, dtype=torch.int32):
        """Zero rows of the pool: a ``ShardRows`` over the mesh's shards."""
        if self._mesh is not None:
            return self._mesh.zeros(shape, dtype)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _sync(self) -> None:
        """Fence: wait for the device work queued so far, on every
        device."""
        if self.device.type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)

    # -- elastic slot pool (delegated to runtime.SlotPool) -------------------

    @property
    def capacity(self) -> int:
        """Current pool size (<= ``max_capacity``)."""
        return self._slots.capacity

    @property
    def max_capacity(self) -> int:
        """Capacity ceiling the elastic pool doubles toward."""
        return self._slots.max_capacity

    @property
    def shard_capacity(self) -> int:
        """Current per-shard pool size (== ``capacity`` with no mesh)."""
        return self._slots.shard_capacity

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
        self._spare = None  # remade at the new capacity by the next hop

    def slot_axes(self):
        n = len(self.plan.convs)
        return ((0,) * n, (0,) * n, 0)

    def shard(self, x, axis: int = 0):
        """Settle a resized or remapped leaf onto the mesh: each shard's
        part on its device (they are made there: nothing moves)."""
        if isinstance(x, ShardRows):
            return ShardRows(p.to(d) for p, d in zip(x.parts,
                                                     self._mesh.devices))
        return x

    def apply_host_remap(self, remap: dict[int, int], new_cap: int) -> None:
        """Ride the host-side ingest plane through a slot remap, so a
        stream's inbox/detector/bookkeeping rows stay glued to its slot."""
        self._arena.apply_remap(remap, new_cap)
        self._detector.apply_remap(remap, new_cap)
        self._slot_sid = remap_rows(self._slot_sid, remap, new_cap, fill=-1)
        self._primed_mask = remap_rows(self._primed_mask, remap, new_cap)
        self._frames_v = remap_rows(self._frames_v, remap, new_cap)
        self._model_idx_v = remap_rows(self._model_idx_v, remap, new_cap)
        self._model_rows_dirty = True
        for s in self._streams.values():
            s.slot = remap[s.slot]
            s.frontend._slot = s.slot
        self._emit_cache = None  # cached rows are indexed by old slots

    def warm(self, capacity: int) -> None:
        self._warm_capacity(capacity)

    # -- tenant weight pool --------------------------------------------------

    @property
    def models(self) -> list[tuple[str, int]]:
        """Resident pool variants as ``(model_id, pool row)`` pairs."""
        if self._pool is None:
            return [(DEFAULT_MODEL, 0)]
        return self._pool.models()

    def register_model(self, model_id: str, weights, thresholds) -> int:
        """Admit one tenant variant into the weight pool; returns its row.

        The variant must share the default model's plan geometry (same
        spec, same hop).  Admission writes one row of every
        device-resident ``(K, ...)`` stack, raw and laid out; shapes never
        change.  When the pool is full, the least-recently-used variant
        with NO live streams is evicted (MemoryError when every row is
        pinned).  Re-admitting a resident id is an LRU touch.
        """
        if self._pool is None:
            raise ValueError(
                "single-model scheduler: construct with max_models > 1 "
                "to enable the tenant weight pool"
            )
        if model_id in self._pool:
            row, _ = self._pool.admit(model_id, weights, thresholds)
            return row
        row, evicted = self._pool.admit(model_id, weights, thresholds)
        w, t = self._pool.params_for(model_id)
        if self._mesh is None:
            self._model.set_model_row(
                row, prepared_model_params(self.plan, w, t, self.device))
        else:
            self._model.set_model_row(row, lambda d: prepared_model_params(
                self.plan, w, t, d))
        if evicted is not None:
            self.metrics.on_model_evict(evicted)
            self.obs.events.emit("model_evict", model=evicted, row=row)
        self.metrics.on_model_admit(model_id)
        self.obs.events.emit("model_admit", model=model_id, row=row,
                             evicted=evicted)
        return row

    def _stream_params(self, s: _Stream):
        """The weights/thresholds the stream's slot computes with."""
        if self._pool is None or s.model == DEFAULT_MODEL:
            return self.weights, self.thresholds
        return self._pool.params_for(s.model)

    def _sync_model_rows(self) -> None:
        """Rebuild the per-slot tenant rows block-uniformly from the live
        streams.  The kernels gather ONE weight row per tenant block, so
        every slot of a block — free slots included — must carry the
        block's bound row: a freed or remapped slot left stale (or reset
        to 0) would steer its whole block to the wrong weights.  Coalesced
        by a dirty flag so joins/closes/resizes pay it once per hop."""
        if self._pool is None or not self._model_rows_dirty:
            return
        v = np.zeros(self.capacity, np.int32)
        tb = min(self._tenant_block, self._slots.shard_capacity)
        for s in self._streams.values():
            b0 = (s.slot // tb) * tb
            v[b0:b0 + tb] = self._pool.index_of(s.model)
        self._model_idx_v = v
        self._model_rows_dirty = False
        self._model_idx_dev = None  # rows changed: the next hop re-stages

    # -- stream lifecycle ----------------------------------------------------

    def add_stream(self, sid: int | None = None,
                   frontend_cfg: FrontendConfig | None = None,
                   model: str | None = None) -> int:
        """Claim a slot for a new stream (growing the pool if needed);
        returns the stream id.  With a tenant pool, ``model`` binds the
        stream to a registered variant (default: the construction
        weights); placement keeps every ``tenant_block`` slot block
        single-model."""
        sid = self._next_sid if sid is None else sid
        assert sid not in self._streams, f"stream {sid} already exists"
        with self.obs.trace.span("join", sid=sid) as sp:
            ph = sp.phases(JOIN_PHASES)
            slot, model_id, midx = self._join_alloc(sid, model)
            ph.mark()
            self._next_sid = max(self._next_sid, sid) + 1
            self._streams[sid] = _Stream(
                sid=sid,
                slot=slot,
                frontend=AudioFrontend(frontend_cfg, arena=self._arena,
                                       slot=slot),
                events=[],
                model=model_id,
            )
            self._slot_sid[slot] = sid
            self._model_idx_v[slot] = midx
            self._model_rows_dirty = True  # block fill happens at sync
            ph.mark()
            self._detector.reset_slot(slot)
            ph.mark()
            self._unprimed.add(sid)
            self.metrics.on_join(sid)
            self.obs.events.emit("join", sid=sid, slot=slot,
                                 shard=slot // self._slots.shard_capacity)
            ph.mark()
        ph.record()
        return sid

    def _join_alloc(self, sid: int, model: str | None
                    ) -> tuple[int, str, int]:
        """A joining stream's tenant row and slot -> (slot, model id, pool
        row)."""
        if self._pool is not None:
            model_id = DEFAULT_MODEL if model is None else model
            if model_id not in self._pool:
                raise KeyError(
                    f"unknown model {model_id!r}; register_model() first"
                )
            midx = self._pool.acquire(model_id)
        else:
            if model is not None:
                raise ValueError(
                    "model binding needs a tenant pool (max_models > 1)"
                )
            model_id, midx = DEFAULT_MODEL, 0
        try:
            # grow-on-demand alloc (pow-2 doubling to the ceiling) is the
            # pool's; it raises MemoryError when every slot stays busy
            slot = self._slots.alloc(sid, model=model_id)
        except MemoryError:
            if self._pool is not None:
                self._pool.release(model_id)
            raise
        return slot, model_id, midx

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
        bit-identical to sequential pushes.  The registry counts the
        arena rows a call lands (``stream.push_rows``) and those that
        took the arena's block path (``stream.push_block_rows``)."""
        with self.obs.trace.span("push", n=len(sids)) as sp:
            ph = sp.phases(PUSH_PHASES)
            streams = [self._require(sid) for sid in sids]
            slots = np.fromiter((s.slot for s in streams), np.int64,
                                len(streams))
            if np.unique(slots).size != slots.size:
                slots, chunks, extra = self._coalesce_chunks(slots, chunks)
            else:
                extra = None
            ph.mark()
            block = self._arena.push_batch(slots, chunks, mark=ph.mark)
            reg = self.obs.registry
            reg.counter("stream.push_rows").inc(int(slots.size))
            reg.counter("stream.push_block_rows").inc(block)
            if extra is not None:
                # credit the chunks the coalesce merged away (push_batch
                # counted one per slot) so chunks_in stays arrival-accurate
                self._arena.chunks_in[slots] += extra
                self._arena.total_chunks_in += int(extra.sum())
            ph.mark()
        ph.record()

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
        # one vectorized warm-up per tenant model (a single group without
        # a pool): each group's rows land via the same batched scatters
        if self._pool is None:
            groups = [(self.weights, self.thresholds,
                       np.arange(len(sids), dtype=np.int64))]
        else:
            by_model: dict[str, list[int]] = {}
            for j, sid in enumerate(sids):
                by_model.setdefault(self._streams[sid].model, []).append(j)
            groups = [
                (*self._stream_params(self._streams[sids[pos[0]]]),
                 np.asarray(pos, np.int64))
                for pos in by_model.values()
            ]
        for w, t, pos in groups:
            steady = prime_batch(self.plan, w, t, samples[pos])
            gslots = slots[pos]
            for i in range(len(self.plan.convs)):
                self._put_rows(self._tails[i], gslots, steady["tails"][i])
                if self._pendings[i].shape[1]:
                    self._put_rows(self._pendings[i], gslots,
                                   steady["pendings"][i])
            self._put_rows(self._gap, gslots, steady["gap"])
            self._frames_v[gslots] = steady["frames"]
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

    def _put_rows(self, x, slots: np.ndarray, values: np.ndarray) -> None:
        """``x[slots] = values`` (int32 host rows) on the device(s) ``x``
        lies on."""
        if isinstance(x, ShardRows):
            x.put_rows(slots, np.ascontiguousarray(values, np.int32))
            return
        x[torch.as_tensor(slots, device=self.device)] = torch.as_tensor(
            np.ascontiguousarray(values, np.int32), device=self.device)

    @staticmethod
    def _row(x, slot: int) -> torch.Tensor:
        """Slot ``slot``'s row of ``x``, a view on the device it lies on."""
        if isinstance(x, ShardRows):
            s, r = x.locate(slot)
            return x.parts[s][r]
        return x[slot]

    def _clear_slot(self, slot: int) -> None:
        for i in range(len(self.plan.convs)):
            self._row(self._tails[i], slot).zero_()
            if self._pendings[i].shape[1]:
                self._row(self._pendings[i], slot).zero_()
        self._row(self._gap, slot).zero_()

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
        st = StreamState(self.plan, *self._stream_params(s))
        st.import_steady(
            [t[s.slot] for t in tails],
            [p[s.slot] for p in pendings],
            gap[s.slot],
            int(self._frames_v[s.slot]),
        )
        st.samples_seen = s.frontend.samples_in - len(s.frontend)
        return st

    def _hop_barriers(self) -> None:
        """Hop-boundary housekeeping: the pool's rebalance-on-skew (a
        cross-shard migration when leave churn skewed the shards) and the
        shrink it unpins, then the mass-join primer."""
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
        shard_counts = np.bincount(ready_slots // self._slots.shard_capacity,
                                   minlength=self.n_shards)
        t_pack = self._clock()
        return ready_slots, ready_mask, audio, shard_counts, t0, t_pack

    def _spare_set(self):
        """The donated state set the next hop writes: the set the last
        hop read, or a new one when a remap dropped it."""
        if self._spare is None:
            self._spare = tree_map(_empty_like, self.device_state())
        return self._spare

    def _dispatch_hop(self, ready_mask, audio) -> _Dispatched:
        """Dispatch stage: stage the operands through the host staging
        ring, enqueue the batched hop, the copies of its logits and
        posteriors to the host and an event after them on each device, and
        reassign the resident state.  Nothing here waits on the device:
        every copy is ``non_blocking`` from or into pinned memory on the
        kernels' CUDA stream of its device.  The launches the hop made
        are counted through ``kernels.dispatch``."""
        stg = self._staging
        i = stg.next()
        args = (
            stg.to_device(i, "audio", audio),
            stg.to_device(i, "mask", ready_mask),
            tuple(self._tails), tuple(self._pendings), self._gap,
        )
        if self._pool is not None:
            self._sync_model_rows()
            if self._model_idx_dev is None:
                # the rows move only on join/close/resize, not per hop
                self._model_idx_dev = stg.to_device(i, "model_idx",
                                                    self._model_idx_v)
            args = args + (self._model_idx_dev,)
        state_in = self.device_state()
        out = self._spare_set() if self._donate else None
        n0 = dispatch.count()
        res = self._model.step(*args, emit=self.emit_logits, out=out)
        n_disp = dispatch.count() - n0
        if self._donate:
            self._spare = state_in  # the next hop writes the set just read
        self._tails = list(res[0])
        self._pendings = list(res[1])
        self._gap = res[2]
        logits = post = None
        if self.emit_logits:
            logits = stg.to_host(i, "logits", res[3])
            post = stg.to_host(i, "post", res[4])
        return _Dispatched(logits, post, stg.record(i), n_disp)

    @staticmethod
    def _fence(hop: _Dispatched):
        """Wait for one dispatched hop's copies, on every device; its
        logits and posteriors as numpy (None, None with emit off)."""
        for ev in hop.events:
            ev.synchronize()
        if hop.logits is None:
            return None, None
        # copied out of the staging ring, which a later hop reuses
        return hop.logits.numpy().copy(), hop.post.numpy().copy()

    def _fold_hop(self, ready_slots, shard_counts, logits_h, post_h,
                  t0, t_pack, t_dispatch, t_device,
                  hidden_s: float = 0.0, fold_hidden: bool = False,
                  dispatches: int = 0) -> HopBatch:
        """Fold stage: apply one resolved hop's results to the host-side
        planes — emit cache, frame counters, slot-vectorized detector,
        metrics, lifecycle events, trace spans.  The sync path runs it
        inline right after the fence; the async plane defers it to the
        hop's retirement, strictly in FIFO dispatch order, which keeps
        every per-slot sequence bit-identical to the synchronous schedule.
        ``hidden_s`` is the hop's host time already spent under an earlier
        hop's device time; with ``fold_hidden`` a later hop is executing
        while this fold runs, so the detector phase counts as hidden too.
        ``dispatches`` is the kernel launches the hop made."""
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
        if fold_hidden:
            hidden_s += t_detector - t_device
        model_counts = None
        if self._pool is not None:
            mc = np.bincount(self._model_idx_v[ready_slots],
                             minlength=self._pool.max_models)
            model_counts = {m: int(mc[row]) for m, row in self._pool.models()
                            if mc[row]}
        self.metrics.on_step(
            ready_slots.size, self.plan.frames_per_hop,
            t_detector - t0, host_pack_s=t_pack - t0,
            shard_counts=shard_counts.tolist(), finalized=self.emit_logits,
            dispatch_s=t_dispatch - t_pack, device_s=t_device - t_dispatch,
            detector_s=t_detector - t_device, hidden_s=hidden_s,
            dispatches=dispatches, model_counts=model_counts,
        )
        # fold the arena's push-side counters into the metrics at the hop
        # boundary: two scalar reads
        self.metrics.on_push_fold(self._arena.total_samples_in,
                                  self._arena.total_chunks_in)
        t_end = self._clock()
        # hop trace: on the sync path the stamps are consecutive, so the
        # phase spans tile the hop span exactly; under the async plane hop
        # N+1's pack/dispatch spans overlap hop N's device span, which
        # union coverage (``coverage(mode="overlap")``) accounts for.
        # One batched call, B-independent.
        n_ready = int(ready_slots.size)
        trace = self.obs.trace
        trace.add_batch((
            ("pack", t0, t_pack - t0, {"n": n_ready}),
            ("dispatch", t_pack, t_dispatch - t_pack, {}),
            ("device", t_dispatch, t_device - t_dispatch,
             {"dispatches": dispatches}),
            ("detector", t_device, t_detector - t_device, {}),
            ("push_fold", t_detector, t_end - t_detector, {}),
        ), parent=trace.add("hop", t0, t_end - t0, n=n_ready))
        return HopBatch(sids=sids, frames=frames, logits=rows_logits,
                        posteriors=rows_post, detections=detections)

    def step_batch(self) -> HopBatch | None:
        """Advance every stream that has a full hop buffered; None when no
        stream is ready.

        The steady-state hot path, with NO python loop over slots:
        readiness is one vectorized compare over the arena, hop packing is
        one gather, bookkeeping updates are fancy-indexed vector ops, and
        detection advances through the slot-vectorized detector.  The body
        is pack -> dispatch -> fence -> fold, each stage a method the async
        plane (``AsyncStreamScheduler``) reuses with the fence and fold
        deferred to the hop's retirement.
        """
        self._hop_barriers()
        packed = self._pack_ready()
        if packed is None:
            self._slots.maybe_prewarm()  # starved step = idle; warm the grow
            return None
        ready_slots, ready_mask, audio, shard_counts, t0, t_pack = packed
        hop = self._dispatch_hop(ready_mask, audio)
        # the device phase is the fence (the hop's event) + the host copy
        # out of the staging ring: without the fence, wall time would
        # measure the enqueue, not the execution
        t_dispatch = self._clock()
        logits_h, post_h = self._fence(hop)
        t_device = self._clock()
        return self._fold_hop(ready_slots, shard_counts, logits_h, post_h,
                              t0, t_pack, t_dispatch, t_device,
                              dispatches=hop.dispatches)

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
            z((cap,), torch.bool),
            tuple(z((cap, st.tail, st.cin)) for st in plan.convs),
            tuple(z((cap, st.phase, st.cout)) for st in plan.convs),
            z((cap, plan.gap_channels)),
        )
        if self._pool is not None:
            args = args + (z((cap,)),)
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
            fargs = (tuple(self._tails), tuple(self._pendings), self._gap)
            if self._pool is not None:
                self._sync_model_rows()
                rows = (torch.as_tensor(self._model_idx_v, device=self.device)
                        if self._mesh is None
                        else self._mesh.split(self._model_idx_v))
                fargs = fargs + (rows,)
            logits, _ = self._model.finalize(*fargs)
            return self._row(logits, s.slot).cpu().numpy()
        return self._peek_fallback(s)

    def _peek_fallback(self, s: _Stream) -> np.ndarray:
        if s.primed:
            st = self._extract_slot(s)
        else:
            st = StreamState(self.plan, *self._stream_params(s))
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
            st = StreamState(self.plan, *self._stream_params(s))
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
        if self._pool is not None:
            self._pool.release(s.model)  # unpin; LRU may now evict it
        self._clear_slot(s.slot)  # scrub so the next tenant starts clean
        self._arena.clear_slot(s.slot)
        self._detector.reset_slot(s.slot)
        self._slot_sid[s.slot] = -1
        self._primed_mask[s.slot] = False
        self._frames_v[s.slot] = 0
        # never zero the slot's tenant row: its block may still be bound
        # to a tenant; the sync rebuilds the rows block-uniformly
        self._model_rows_dirty = True
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
