"""Per-stream sliding-window state for incremental KWS inference.

The offline executor re-reads the whole feature map per layer.  Streaming
instead keeps, per conv layer, only the *receptive-field tail*: the suffix
of the (padded) input stream that future output positions still need.  The
tail lives in a ``FrameRing`` — a fixed-capacity ring whose read/write
pointers mirror the flexible ping-pong SRAM discipline of
``core/pingpong.py`` (paper §II-F): instead of re-allocating a buffer per
layer invocation, the pointers chase each other through a fixed region and
wrap, and over/under-runs raise ``MemoryError`` exactly like the ping-pong
model's bank checks.

Steady-state geometry (``plan_stream``): once a stream has been primed with
``prime_samples``, every hop of ``hop_samples`` audio makes each layer
consume/emit a *constant* number of frames and keeps each tail at a
*constant* length with a *constant* pool phase.  That is what lets the
scheduler run one batched step with fully static shapes — including
the per-hop *finalization tail* (ghost flush + classifier), whose emission
counts are the ``flush_*`` fields below.  Priming, odd-sized chunks,
end-of-stream flush and mid-hop peeks over leftover (sub-hop) samples run
through the generic numpy path in ``StreamState`` — the bit-exact
reference implementation of the same math, kept as the oracle and the
exact fallback.

Bit-exactness contract with core/executor.py (verified in test_stream.py):
  * layer-0 spatial padding uses the offset code (ref_bitserial_conv1d)
  * binary layers pad with zeros
  * fused max-pool = OR over non-overlapping windows, remainder dropped
  * GAP counts saturate at 255 (8-bit PWB counters)
  * fc layers run on the saturated counts; final layer emits raw logits
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
# SlotPlacement and the host remap contract live in the generic runtime
# package (repro_torch.runtime); they are re-exported here, as in the
# reference package, because the streaming API grew up around this module.
from repro_torch.runtime.placement import SlotPlacement  # noqa: F401
from repro_torch.runtime.remap import remap_rows  # noqa: F401


# ---------------------------------------------------------------------------
# Ring buffer
# ---------------------------------------------------------------------------

class FrameRing:
    """Fixed-capacity FIFO of (channels,) frames with wrapping pointers.

    ``wr``/``rd`` are monotonic frame counters; the physical slot is the
    counter mod capacity, so the region is reused forever without copies —
    the software twin of the ping-pong SRAM's per-layer pointer latching
    (PTR instructions move pointers, never data).
    """

    def __init__(self, capacity: int, channels: int, dtype=np.int32) -> None:
        assert capacity > 0 and channels > 0
        self.capacity = capacity
        self.channels = channels
        self.data = np.zeros((capacity, channels), dtype=dtype)
        self.rd = 0  # next frame to read (monotonic)
        self.wr = 0  # next frame to write (monotonic)

    def __len__(self) -> int:
        return self.wr - self.rd

    @property
    def free(self) -> int:
        return self.capacity - len(self)

    def push(self, frames: np.ndarray) -> None:
        frames = np.atleast_2d(frames)
        n = frames.shape[0]
        if n == 0:
            return
        assert frames.shape[1] == self.channels, (frames.shape, self.channels)
        if n > self.free:
            raise MemoryError(
                f"ring overflow: push {n} into {self.free} free of "
                f"{self.capacity} frames"
            )
        idx = (self.wr + np.arange(n)) % self.capacity
        self.data[idx] = frames
        self.wr += n

    def pop(self, n: int) -> np.ndarray:
        out = self.peek(n)
        self.rd += n
        return out

    def peek(self, n: int | None = None) -> np.ndarray:
        """Oldest ``n`` frames (default: all) in time order, without consuming."""
        n = len(self) if n is None else n
        if n > len(self):
            raise MemoryError(f"ring underflow: peek {n} of {len(self)}")
        idx = (self.rd + np.arange(n)) % self.capacity
        return self.data[idx].copy()

    def drop(self, n: int) -> None:
        if n > len(self):
            raise MemoryError(f"ring underflow: drop {n} of {len(self)}")
        self.rd += n

    def clone(self) -> "FrameRing":
        r = FrameRing(self.capacity, self.channels, self.data.dtype)
        r.data = self.data.copy()
        r.rd, r.wr = self.rd, self.wr
        return r

    def load(self, frames: np.ndarray) -> None:
        """Reset contents to exactly ``frames`` (keeps pointer positions
        rolling forward — the region is reused, not reallocated)."""
        frames = np.atleast_2d(frames)
        self.rd = self.wr
        self.push(frames)


# ---------------------------------------------------------------------------
# Ring arena: one shared sample inbox for every stream slot
# ---------------------------------------------------------------------------

IN_OFFSET = 128  # offset-binary zero code (models/kws.py)


def quantize_pcm(x: np.ndarray, gain=1.0) -> np.ndarray:
    """float PCM in [-1, 1] -> u8 offset-binary codes.

    ``gain`` may be a scalar or a per-sample vector (the arena repeats each
    stream's fixed gain across its samples so many streams quantize in one
    call); streaming cannot use the offline corpus's per-clip peak
    normalization because the clip never ends.
    """
    q = np.round(np.clip(x * gain, -1.0, 1.0) * 127.0) + IN_OFFSET
    return np.clip(q, 0, 255).astype(np.uint8)


def _u8_codes(ints: list[np.ndarray]) -> np.ndarray:
    """Integer chunks as one flat array of u8 codes.  A chunk whose dtype
    is not an integer raises ``TypeError``, a code outside [0, 255]
    ``ValueError``, before anything is written."""
    for c in ints:
        if c.dtype.kind not in "iu":
            raise TypeError(
                f"audio must be float PCM or integer u8 codes, "
                f"got dtype {c.dtype}"
            )
    codes = np.concatenate(ints)
    if codes.dtype != np.uint8 and codes.size and (
        codes.min() < 0 or codes.max() > 255
    ):
        raise ValueError(
            f"integer sample codes out of u8 range [0, 255]: "
            f"min {codes.min()}, max {codes.max()}"
        )
    return codes.astype(np.uint8, copy=False)


class RingArena:
    """Struct-of-arrays sample inbox shared by EVERY stream slot.

    The pre-arena runtime gave each stream its own ``AudioFrontend`` ring
    object, so packing a hop at B streams cost B python ring pops — the
    serial floor of the whole runtime at B=1024.  The arena instead holds
    ONE ``(capacity_slots, capacity_samples)`` uint8 buffer plus per-slot
    monotonic read/write counters, the array-of-objects ->
    struct-of-arrays turn of the paper's §II-D ping-pong feature SRAM
    argument: one shared, layout-flexible buffer beats per-tenant buffers.
    Every hot-path operation is one vectorized call:

      * ``push_batch``   quantize + land chunks for many streams at once
                         (whole block rows when the pushes are hop-aligned)
      * ``ready_mask``   which slots hold >= n samples (one compare)
      * ``pack_hops``    gather every ready slot's hop window into the
                         batched ``(capacity_slots, hop)`` int32 step input
                         and consume it — pure fancy indexing

    Samples are stored as uint8 codes (4x smaller than the old per-stream
    ``(n, 1)`` int32 rings) and widened to int32 only at pack time.  Rows
    follow ``SlotPlacement`` through elastic resizes via ``apply_remap``,
    so a slot's inbox never crosses shard blocks.  Like ``FrameRing``,
    over/under-runs raise ``MemoryError``; unlike it, a malformed push is
    rejected at the boundary (wrong dtype, out-of-range codes) instead of
    being silently widened.
    """

    def __init__(self, capacity_slots: int, capacity_samples: int) -> None:
        assert capacity_slots > 0 and capacity_samples > 0
        self.capacity_samples = capacity_samples
        self.data = np.zeros((capacity_slots, capacity_samples), np.uint8)
        self.rd = np.zeros(capacity_slots, np.int64)  # monotonic, per slot
        self.wr = np.zeros(capacity_slots, np.int64)  # monotonic, per slot
        self.samples_in = np.zeros(capacity_slots, np.int64)
        self.chunks_in = np.zeros(capacity_slots, np.int64)
        self.gain = np.ones(capacity_slots, np.float64)
        # fleet totals: monotone even across slot clears, so the metrics
        # fold at hop boundaries is two scalar reads, never a per-slot walk
        self.total_samples_in = 0
        self.total_chunks_in = 0
        # seqlock word for the async ingest pump: odd while a mutation is
        # in progress, bumped to the next even value when it completes.
        # Mutators run under the scheduler's ingest lock; the generation
        # lets lock-FREE observers (`read_consistent`) detect and retry a
        # read that raced a writer instead of returning torn state.
        self.generation = 0
        self.read_retries = 0  # consistency retries observed (stats only)

    @contextlib.contextmanager
    def _write(self):
        """Mark a mutation window: generation is odd for its duration.
        Validation must happen BEFORE entering, so a rejected operation
        leaves the generation untouched (still even)."""
        self.generation += 1
        try:
            yield
        finally:
            self.generation += 1

    def read_consistent(self, fn, max_retries: int = 100_000):
        """Seqlock read: evaluate ``fn()`` at a moment no writer is
        mid-mutation and re-check afterwards, retrying on a torn window.
        ``fn`` must be a pure read of arena state (it may run more than
        once).  Returns ``fn()``'s value from the first clean window."""
        for _ in range(max_retries):
            g0 = self.generation
            if g0 & 1:  # writer mid-flight: spin
                self.read_retries += 1
                continue
            out = fn()
            if self.generation == g0:
                return out
            self.read_retries += 1
        raise RuntimeError(
            "read_consistent starved: a writer never left the arena"
        )

    @property
    def capacity_slots(self) -> int:
        return self.data.shape[0]

    def fill(self) -> np.ndarray:
        """Live sample count per slot, (capacity_slots,) int64."""
        return self.wr - self.rd

    def fill_of(self, slot: int) -> int:
        return int(self.wr[slot] - self.rd[slot])

    def ready_mask(self, n: int) -> np.ndarray:
        """Which slots hold at least ``n`` samples — the scheduler's
        readiness test, one vectorized compare over the whole pool."""
        return (self.wr - self.rd) >= n

    def set_gain(self, slot: int, gain: float) -> None:
        self.gain[slot] = gain

    # -- ingest (quantize + scatter) -----------------------------------------

    def push(self, slot: int, audio: np.ndarray) -> int:
        """Append one stream's chunk (float PCM or u8 codes); 1 if it
        took ``push_batch``'s block path, else 0."""
        return self.push_batch(np.array([slot], np.int64), [audio])

    def push_batch(self, slots: np.ndarray, chunks: list[np.ndarray],
                   mark=None) -> int:
        """Append one chunk per slot for many streams in one call.

        Float chunks are quantized in a single vectorized pass with each
        stream's fixed gain, integer chunks are range-checked in a single
        pass, and everything lands in the arena in ONE assignment — no
        python loop over samples.  Slots must be unique within a call
        (chunk order per slot would otherwise be ambiguous).  The call
        stages as one flat u8 array; its landing takes one of two paths,
        chosen by the call's shape and the arena's pointers alone, with
        the same resulting state:

          * block: every chunk has one length ``L``, ``L`` divides the
            region and every slot's write offset is a multiple of ``L``,
            so no chunk can wrap.  The staged array, reshaped to ``(n,
            L)``, lands as whole block rows of a ``(slots, cap // L, L)``
            view of the arena — the twin of ``pack_hops``' aligned
            gather, with no per-sample index array.  The scheduler's
            steady state is here: whole hops into inboxes sized in whole
            hops and rebased at priming.  Chunks of any other length
            (say 20 ms frames into an inbox of whole hops) stay flat.
          * flat: anything else scatters the staged array through (row,
            wrapped column) index arrays, one entry per sample.

        ``mark`` (the caller's ``Phases.mark``) is called once the samples
        are staged and once their landing coordinates are built (block
        indices or index arrays).  Returns how many rows took the block
        path: ``len(slots)`` or 0.
        """
        slots = np.asarray(slots, np.int64)
        assert slots.size == len(chunks), (slots.size, len(chunks))
        if slots.size == 0:
            return 0
        if np.unique(slots).size != slots.size:
            raise ValueError("push_batch slots must be unique per call")
        chunks = [np.asarray(c).reshape(-1) for c in chunks]
        lens = np.array([c.size for c in chunks], np.int64)
        cap = self.capacity_samples
        free = cap - (self.wr[slots] - self.rd[slots])
        if (lens > free).any():
            worst = int(np.argmax(lens - free))
            raise MemoryError(
                f"arena overflow: push {lens[worst]} into {free[worst]} "
                f"free of {cap} samples (slot {slots[worst]})"
            )
        is_f = np.array([c.dtype.kind == "f" for c in chunks], bool)
        total = int(lens.sum())
        # stage one flat u8 array: a call of one kind concatenates, only a
        # mixed call places each kind through a per-sample mask
        if is_f.all():
            staged = self._quantize(slots, chunks, lens)
        elif not is_f.any():
            staged = _u8_codes(chunks)
        else:
            staged = np.empty(total, np.uint8)
            sample_is_f = np.repeat(is_f, lens)
            staged[sample_is_f] = self._quantize(
                slots[is_f], [c for c, f in zip(chunks, is_f) if f],
                lens[is_f])
            staged[~sample_is_f] = _u8_codes(
                [c for c, f in zip(chunks, is_f) if not f])
        if mark is not None:
            mark()
        width = int(lens[0])
        start = self.wr[slots] % cap
        block = bool(width and cap % width == 0 and (lens == width).all()
                     and not (start % width).any())
        if block:
            # block path: slot s's chunk is block start // width of its row
            dst = self.data.reshape(self.capacity_slots, cap // width, width)
            at = (slots, start // width)
            staged = staged.reshape(slots.size, width)
        else:
            # flat scatter: (slot row, wrapped column) per sample
            starts = np.cumsum(lens) - lens
            rows = np.repeat(slots, lens)
            offs = np.arange(total) - np.repeat(starts, lens)
            cols = (np.repeat(self.wr[slots], lens) + offs) % cap
            dst, at = self.data, (rows, cols)
        if mark is not None:
            mark()
        with self._write():
            dst[at] = staged
            self.wr[slots] += lens
            self.samples_in[slots] += lens
            self.chunks_in[slots] += 1
            self.total_samples_in += total
            self.total_chunks_in += slots.size
        return slots.size if block else 0

    def _quantize(self, slots: np.ndarray, chunks: list[np.ndarray],
                  lens: np.ndarray) -> np.ndarray:
        """Float chunks as one flat array of u8 codes, each stream's fixed
        gain repeated across its samples."""
        return quantize_pcm(np.concatenate(chunks),
                            np.repeat(self.gain[slots], lens))

    # -- drain ---------------------------------------------------------------

    def pack_hops(self, ready_slots: np.ndarray, hop: int) -> np.ndarray:
        """Consume one ``hop``-sample window from every ready slot into the
        batched ``(capacity_slots, hop)`` int32 step input.

        Pure fancy indexing — one flat gather, one pointer bump —
        regardless of how many streams are ready; rows not in
        ``ready_slots`` are zero (they ride through the batched step
        masked).  ``ready_slots`` must be sorted unique slot indices (what
        ``np.nonzero(ready_mask(...))`` yields).  The per-sample index
        math runs un-wrapped and only rows whose window crosses the region
        end pay the wrap fix, so the steady-state gather is one
        broadcast-add plus one take over the flat arena.
        """
        out = np.zeros((self.capacity_slots, hop), np.int32)
        ready_slots = np.asarray(ready_slots, np.int64)
        if ready_slots.size == 0:
            return out
        if ((self.wr[ready_slots] - self.rd[ready_slots]) < hop).any():
            raise MemoryError(
                f"arena underflow: pack_hops({hop}) on a slot holding less"
            )
        cap = self.capacity_samples
        with self._write():
            # the gather itself sits inside the write window: pack is a
            # CONSUMER (it bumps rd), so lock-free observers must treat
            # the whole read-and-consume as one mutation
            start = self.rd[ready_slots] % cap
            if cap % hop == 0 and not (start % hop).any():
                # aligned fast path: every window is one whole block of a
                # (slots, blocks, hop) view of the arena, so the gather is
                # a contiguous block-row take — no per-sample index array.
                # The scheduler keeps slots on this path by rebasing each
                # inbox once at priming (rebase) and sizing the arena in
                # whole hops.
                view = self.data.reshape(self.capacity_slots, cap // hop,
                                         hop)
                gathered = view[ready_slots, start // hop]
            else:
                idx = (ready_slots * cap + start)[:, None] + np.arange(hop)
                over = start + hop > cap  # windows wrapping past region end
                if over.any():
                    row_end = ((ready_slots[over] + 1) * cap)[:, None]
                    sub = idx[over]
                    idx[over] = np.where(sub >= row_end, sub - cap, sub)
                gathered = self.data.reshape(-1)[idx]
            if ready_slots.size == self.capacity_slots:
                out = gathered.astype(np.int32)  # all ready: skip scatter
            else:
                out[ready_slots] = gathered
            self.rd[ready_slots] += hop
        return out

    def rebase(self, slot: int) -> None:
        """Move one slot's live samples to offset 0 (pointers reset, data
        compacted).  The scheduler calls this once per stream right after
        priming: from then on the hot path only consumes whole hops, so
        the slot's windows stay block-aligned: ``pack_hops`` takes the
        contiguous fast path forever, and ``push_batch`` its block path
        for every whole-hop push."""
        self.rebase_batch(np.array([slot], np.int64))

    def rebase_batch(self, slots: np.ndarray) -> None:
        """``rebase`` for many slots in one vectorized gather/scatter —
        the mass-join twin: a B-stream join realigns all B inboxes without
        a python loop over slots."""
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return
        with self._write():
            n = self.wr[slots] - self.rd[slots]
            m = int(n.max())
            if m:
                idx = (self.rd[slots][:, None]
                       + np.arange(m)) % self.capacity_samples
                vals = self.data[slots[:, None], idx]
                keep = np.arange(m)[None, :] < n[:, None]
                cur = self.data[slots, :m]
                self.data[slots, :m] = np.where(keep, vals, cur)
            self.rd[slots] = 0
            self.wr[slots] = n

    def peek(self, slot: int, n: int | None = None) -> np.ndarray:
        """Oldest ``n`` samples (default: all) of one slot as (n,) int32
        u8-codes, without consuming — the host-path (priming/flush) view."""
        have = self.fill_of(slot)
        n = have if n is None else int(n)
        if n > have:
            raise MemoryError(f"arena underflow: peek {n} of {have} "
                              f"(slot {slot})")
        idx = (self.rd[slot] + np.arange(n)) % self.capacity_samples
        return self.data[slot, idx].astype(np.int32)

    def pop(self, slot: int, n: int) -> np.ndarray:
        out = self.peek(slot, n)
        with self._write():
            self.rd[slot] += n
        return out

    def pop_batch(self, slots: np.ndarray, n: int) -> np.ndarray:
        """Consume the oldest ``n`` samples of many slots in one gather;
        returns (len(slots), n) int32 u8-codes — the batched primer's
        warm-up read (every joining stream pops ``prime_samples`` at
        once)."""
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return np.zeros((0, n), np.int32)
        if ((self.wr[slots] - self.rd[slots]) < n).any():
            raise MemoryError(
                f"arena underflow: pop_batch({n}) on a slot holding less"
            )
        with self._write():
            idx = (self.rd[slots][:, None]
                   + np.arange(n)) % self.capacity_samples
            out = self.data[slots[:, None], idx].astype(np.int32)
            self.rd[slots] += n
        return out

    # -- slot lifecycle ------------------------------------------------------

    def clear_slot(self, slot: int) -> None:
        """Scrub one row so the next tenant starts clean (the fleet-level
        ``total_*`` counters keep counting across tenants)."""
        with self._write():
            self.data[slot] = 0
            self.rd[slot] = self.wr[slot] = 0
            self.samples_in[slot] = 0
            self.chunks_in[slot] = 0
            self.gain[slot] = 1.0

    def apply_remap(self, remap: dict[int, int], new_capacity_slots: int
                    ) -> None:
        """Follow a ``SlotPlacement`` grow/shrink/rebalance: surviving
        rows move to their new slots with one vectorized gather per
        array; vacated rows reset.  Resizes keep rows inside their shard
        block; a ``rebalance`` remap is the one path that moves rows
        across blocks (mirroring the device-side
        ``ops.remap_slot_rows`` gather).
        """
        with self._write():
            self.data = remap_rows(self.data, remap, new_capacity_slots)
            self.rd = remap_rows(self.rd, remap, new_capacity_slots)
            self.wr = remap_rows(self.wr, remap, new_capacity_slots)
            self.samples_in = remap_rows(self.samples_in, remap,
                                         new_capacity_slots)
            self.chunks_in = remap_rows(self.chunks_in, remap,
                                        new_capacity_slots)
            self.gain = remap_rows(self.gain, remap, new_capacity_slots,
                                   fill=1.0)


# ---------------------------------------------------------------------------
# Stream plan: static per-hop geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvStage:
    """One conv layer's static streaming geometry.

    The ``flush_*`` fields describe the *finalization tail*: the extra work
    an end-of-stream flush performs from the steady state (append the right
    pad, convolve what fits, pool with drop-remainder).  Because the steady
    tail/phase lengths are constants of the plan, so are these counts —
    which is what lets the scheduler compute "logits as if the stream ended
    now" *inside* the batched step instead of on the host.
    """

    layer_idx: int
    name: str
    k: int
    stride: int
    pad: int
    pool: int
    cin: int
    cout: int
    in_bits: int
    in_offset: int
    tail: int      # steady-state receptive-field tail length (frames)
    phase: int     # steady-state pool phase (frames pending in the window)
    n_in: int      # frames consumed per hop
    n_conv: int    # conv positions emitted per hop
    n_out: int     # pooled frames emitted per hop
    flush_in: int    # extra frames received from the layer above at flush
    flush_conv: int  # extra conv positions a flush emits (tail + right pad)
    flush_out: int   # extra pooled frames a flush emits (remainder dropped)


@dataclasses.dataclass(frozen=True)
class FCStage:
    layer_idx: int
    name: str
    cin: int
    cout: int
    in_bits: int
    out_raw: bool


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static schedule for one model: hop/prime sizes + per-layer geometry."""

    spec: CNN1DSpec
    hop_samples: int
    prime_samples: int
    convs: tuple[ConvStage, ...]
    fcs: tuple[FCStage, ...]
    gap_channels: int

    @property
    def frames_per_hop(self) -> int:
        return self.convs[-1].n_out

    @property
    def samples_per_frame(self) -> int:
        return self.hop_samples // self.frames_per_hop

    def macs_per_hop(self) -> int:
        """Logical MACs of one steady-state hop (conv cascade only)."""
        return sum(c.n_conv * c.k * c.cin * c.cout for c in self.convs)

    def fc_macs(self) -> int:
        return sum(f.cin * f.cout for f in self.fcs)


def _conv_layers(spec: CNN1DSpec) -> tuple[list[tuple[int, Conv1DSpec]],
                                           int, list[tuple[int, FCSpec]]]:
    """Split the spec into conv prefix / GAP / fc suffix (the streamable
    topology); anything else is rejected."""
    convs: list[tuple[int, Conv1DSpec]] = []
    fcs: list[tuple[int, FCSpec]] = []
    gap_at = None
    for li, lspec in enumerate(spec.layers):
        if isinstance(lspec, Conv1DSpec):
            if gap_at is not None:
                raise ValueError("conv after GAP is not streamable")
            if lspec.out_raw:
                raise ValueError(f"{lspec.name}: raw-output conv mid-stream")
            convs.append((li, lspec))
        elif isinstance(lspec, GAPSpec):
            if gap_at is not None:
                raise ValueError("multiple GAP layers")
            gap_at = li
        elif isinstance(lspec, FCSpec):
            if gap_at is None:
                raise ValueError("FC before GAP is not streamable")
            fcs.append((li, lspec))
        else:
            raise ValueError(f"layer {li} ({type(lspec).__name__}) not streamable")
    if not convs or gap_at is None or not fcs:
        raise ValueError("streamable spec needs convs -> GAP -> FCs")
    return convs, gap_at, fcs


def _simulate_counts(convs: list[tuple[int, Conv1DSpec]], pushes: list[int]
                     ) -> tuple[list[int], list[int], list[list[int]]]:
    """Feed ``pushes`` chunks through the count-level model.

    Returns (tail lengths, pool phases, per-push emissions per layer) after
    all pushes; tails include the layer's left pad on the first push.
    """
    fed = [0] * len(convs)       # frames of the *padded* stream received
    emitted = [0] * len(convs)   # conv positions emitted so far
    pooled = [0] * len(convs)    # pooled frames emitted so far
    per_push: list[list[int]] = []
    for push in pushes:
        cur = push
        outs = []
        for i, (_, L) in enumerate(convs):
            if fed[i] == 0 and cur > 0:
                fed[i] += L.pad  # left pad arrives with the first real frame
            fed[i] += cur
            total = max(0, (fed[i] - L.k) // L.stride + 1) if fed[i] >= L.k else 0
            new_conv = total - emitted[i]
            emitted[i] = total
            new_pool = (emitted[i] // L.pool) - pooled[i]
            pooled[i] += new_pool
            cur = new_pool
            outs.append(new_conv)
        per_push.append(outs)
    tails = [
        fed[i] - emitted[i] * L.stride for i, (_, L) in enumerate(convs)
    ]
    phases = [emitted[i] % L.pool for i, (_, L) in enumerate(convs)]
    return tails, phases, per_push


def plan_stream(
    spec: CNN1DSpec,
    hop_frames: int = 1,
    prime_samples: int | None = None,
) -> StreamPlan:
    """Derive the static streaming schedule for ``spec``.

    ``hop_frames``: final-layer frames per scheduler step; the hop size in
    samples is ``hop_frames * prod(stride*pool)``.  ``prime_samples`` is the
    warm-up prefix a stream must deliver before it enters the steady-state
    batched step; the default is the smallest stride-aligned prefix that
    fills every layer's tail.
    """
    convs, _, fcs = _conv_layers(spec)
    unit = 1
    for _, L in convs:
        unit *= L.stride * L.pool
    hop = hop_frames * unit

    s0 = convs[0][1].stride
    if prime_samples is None:
        # smallest stride-aligned prefix after which every layer has seen a
        # full receptive field (fed >= k), i.e. every tail is at steady size
        prime_samples = 0
        for p in range(s0, 64 * unit + 1, s0):
            f, ok = p, True
            for _, L in convs:
                f_padded = L.pad + f
                if f_padded < L.k:
                    ok = False
                    break
                f = ((f_padded - L.k) // L.stride + 1) // L.pool
            if ok:
                prime_samples = p
                break
        if prime_samples == 0:
            raise ValueError("could not find a priming prefix")

    # verify steady state: two extra hops give identical emissions + tails
    tails, phases, per = _simulate_counts(convs, [prime_samples, hop, hop])
    tails2, phases2, per2 = _simulate_counts(
        convs, [prime_samples, hop, hop, hop]
    )
    if per[1] != per[2] or per2[2] != per2[3] or tails != tails2 or phases != phases2:
        raise ValueError(
            f"hop {hop} / prime {prime_samples} does not reach steady state"
        )

    # finalization-tail geometry: what an end-of-stream flush emits from the
    # steady state (mirrors StreamState._advance_once with flush=True)
    flush_geom = []
    f_in = 0
    for i, (_, L) in enumerate(convs):
        avail = tails[i] + f_in + L.pad  # tail ++ upstream flush ++ right pad
        f_conv = (avail - L.k) // L.stride + 1 if avail >= L.k else 0
        f_out = (phases[i] + f_conv) // L.pool
        flush_geom.append((f_in, f_conv, f_out))
        f_in = f_out

    stages = []
    n_in = hop
    for i, (li, L) in enumerate(convs):
        n_conv = per[1][i]
        if n_conv % L.pool:
            raise ValueError(
                f"{L.name}: {n_conv} conv frames/hop not divisible by pool "
                f"{L.pool}; raise hop_frames"
            )
        stages.append(
            ConvStage(
                layer_idx=li, name=L.name, k=L.k, stride=L.stride, pad=L.pad,
                pool=L.pool, cin=L.cin, cout=L.cout, in_bits=L.in_bits,
                in_offset=L.in_offset, tail=tails[i], phase=phases[i],
                n_in=n_in, n_conv=n_conv, n_out=n_conv // L.pool,
                flush_in=flush_geom[i][0], flush_conv=flush_geom[i][1],
                flush_out=flush_geom[i][2],
            )
        )
        assert n_conv * L.stride == n_in, (L.name, n_conv, n_in)
        n_in = n_conv // L.pool

    fc_stages = tuple(
        FCStage(li, F.name, F.cin, F.cout, F.in_bits, F.out_raw)
        for li, F in fcs
    )
    return StreamPlan(
        spec=spec,
        hop_samples=hop,
        prime_samples=prime_samples,
        convs=tuple(stages),
        fcs=fc_stages,
        gap_channels=convs[-1][1].cout,
    )


# ---------------------------------------------------------------------------
# Reference per-stream state (numpy; priming / flush / peek path)
# ---------------------------------------------------------------------------

def _threshold(raw: np.ndarray, thr: np.ndarray, flip: np.ndarray) -> np.ndarray:
    """Executor-exact SA binarization (float64 compare, flip channels)."""
    ge = raw >= thr[None, :]
    return np.where(flip[None, :], ~ge, ge).astype(np.uint8)


def _conv_raw(window: np.ndarray, w: np.ndarray, stage: ConvStage,
              n_conv: int) -> np.ndarray:
    """n_conv positions of the layer over ``window`` (tail ++ new frames)."""
    x = window.astype(np.int64)
    if stage.in_bits > 1:
        x = x - stage.in_offset  # offset-binary input (pads carry the code)
    taps = np.stack(
        [
            x[t : t + (n_conv - 1) * stage.stride + 1 : stage.stride]
            for t in range(stage.k)
        ],
        axis=0,
    )  # (K, n_conv, Cin)
    return np.einsum("knc,kco->no", taps, w.astype(np.int64))


class StreamState:
    """One stream's incremental inference state (bit-exact numpy path).

    Handles arbitrary chunk sizes: warm-up, steady hops, end-of-stream flush
    with right padding, and non-destructive mid-stream peeks.  The batched
    batched scheduler path is the steady-state specialization of exactly
    this code.
    """

    def __init__(
        self,
        plan: StreamPlan,
        weights: dict[int, np.ndarray],
        thresholds: dict[int, tuple[np.ndarray, np.ndarray]],
        ring_slack: int | None = None,
    ) -> None:
        self.plan = plan
        self.weights = weights
        self.thresholds = thresholds
        slack = ring_slack if ring_slack is not None else max(
            plan.prime_samples, 2 * plan.hop_samples
        )
        self._max_chunk = slack  # advance() splits larger inputs
        self.hists: list[FrameRing] = []
        self.pendings: list[FrameRing] = []
        for st in plan.convs:
            cap = st.tail + 2 * st.pad + st.k + max(slack, st.n_in) + 1
            self.hists.append(FrameRing(cap, st.cin, np.int32))
            self.pendings.append(
                FrameRing(st.pool + st.k + st.pad + max(slack, st.n_conv) + 1,
                          st.cout, np.int32)
            )
            slack = max(1, -(-slack // max(1, st.stride)))
        self.started = [False] * len(plan.convs)
        self.gap = np.zeros(plan.gap_channels, np.int64)
        self.frames = 0          # final-conv pooled frames accumulated in GAP
        self.samples_seen = 0
        self.flushed = False

    # -- core advance --------------------------------------------------------

    def advance(self, samples: np.ndarray, flush: bool = False) -> np.ndarray:
        """Feed u8 samples (n,) or (n, Cin0); returns newly emitted
        final-conv frames (m, C).  ``flush`` appends each layer's right pad
        and drops incomplete pool windows (end-of-stream semantics)."""
        samples = np.asarray(samples)
        cur = samples.reshape(-1, self.plan.convs[0].cin)
        if cur.shape[0] > self._max_chunk:
            # split oversized inputs so the fixed-capacity rings never
            # overflow (the pointers just wrap more often)
            outs = []
            for i in range(0, cur.shape[0], self._max_chunk):
                seg = cur[i : i + self._max_chunk]
                last = i + self._max_chunk >= cur.shape[0]
                outs.append(self._advance_once(seg, flush=flush and last))
            return np.concatenate(outs, axis=0)
        return self._advance_once(cur, flush=flush)

    def _advance_once(self, samples: np.ndarray, flush: bool) -> np.ndarray:
        assert not self.flushed, "stream already flushed"
        cur = samples.reshape(-1, self.plan.convs[0].cin).astype(np.int32)
        self.samples_seen += cur.shape[0]
        for i, st in enumerate(self.plan.convs):
            hist = self.hists[i]
            w = self.weights[st.layer_idx]
            wk = w.reshape(st.k, st.cin, st.cout)
            if not self.started[i] and (cur.shape[0] > 0 or flush):
                # left pad arrives with the first real frame (offset code
                # for the multi-bit first layer, zeros for binary layers)
                pad_val = st.in_offset if st.in_bits > 1 else 0
                hist.push(np.full((st.pad, st.cin), pad_val, np.int32))
                self.started[i] = True
            hist.push(cur)
            if flush:
                pad_val = st.in_offset if st.in_bits > 1 else 0
                hist.push(np.full((st.pad, st.cin), pad_val, np.int32))
            avail = len(hist)
            n_conv = (avail - st.k) // st.stride + 1 if avail >= st.k else 0
            if n_conv > 0:
                window = hist.peek(avail)
                raw = _conv_raw(window, wk, st, n_conv)
                thr, flip = self.thresholds[st.layer_idx]
                y = _threshold(raw, thr, flip)
                hist.drop(n_conv * st.stride)
            else:
                y = np.zeros((0, st.cout), np.uint8)
            # pool: OR over non-overlapping windows, absolute alignment
            pend = self.pendings[i]
            pend.push(y.astype(np.int32))
            n_pool = len(pend) // st.pool
            if n_pool > 0:
                frames = pend.pop(n_pool * st.pool)
                cur = frames.reshape(n_pool, st.pool, st.cout).max(axis=1)
            else:
                cur = np.zeros((0, st.cout), np.int32)
            if flush:
                pend.drop(len(pend))  # drop-remainder (ref_maxpool1d)
        self.gap += cur.astype(np.int64).sum(axis=0)
        self.frames += cur.shape[0]
        if flush:
            self.flushed = True
        return cur

    # -- logits --------------------------------------------------------------

    def logits(self) -> np.ndarray:
        """fc cascade over the (saturated) GAP counts — executor-exact."""
        h = np.minimum(self.gap, 255).astype(np.int64)[None, :]  # 8-bit PWB
        for st in self.plan.fcs:
            w = self.weights[st.layer_idx].astype(np.int64)
            raw = h @ w
            if st.out_raw:
                h = raw
            else:
                thr, flip = self.thresholds[st.layer_idx]
                h = _threshold(raw, thr, flip).astype(np.int64)
        return h[0]

    def peek_logits(self, extra_samples: np.ndarray | None = None) -> np.ndarray:
        """Logits as if the stream ended now (plus ``extra_samples``),
        without disturbing the live state — the per-frame logits contract:
        peek after feeding audio[:L] == offline executor on audio[:L].

        This is the *exact fallback* path: the scheduler computes per-hop
        finalized logits inside the batched step (the fused
        finalization tail) and only drops to this clone-and-flush numpy
        path for mid-hop peeks that must include leftover sub-hop samples,
        or for streams that are not yet primed."""
        ghost = self.clone()
        if extra_samples is None:
            extra_samples = np.zeros((0,), np.int32)
        ghost.advance(extra_samples, flush=True)
        return ghost.logits()

    def clone(self) -> "StreamState":
        c = StreamState.__new__(StreamState)
        c.plan, c.weights, c.thresholds = self.plan, self.weights, self.thresholds
        c._max_chunk = self._max_chunk
        c.hists = [h.clone() for h in self.hists]
        c.pendings = [p.clone() for p in self.pendings]
        c.started = list(self.started)
        c.gap = self.gap.copy()
        c.frames = self.frames
        c.samples_seen = self.samples_seen
        c.flushed = self.flushed
        return c

    # -- steady-state interchange with the batched scheduler -----------------

    def export_steady(self) -> dict[str, list[np.ndarray] | np.ndarray]:
        """Tail/pending/gap arrays at the plan's steady-state shapes."""
        tails, pends = [], []
        for i, st in enumerate(self.plan.convs):
            h = self.hists[i]
            if len(h) != st.tail:
                raise ValueError(
                    f"{st.name}: tail {len(h)} != steady {st.tail} "
                    "(stream not primed?)"
                )
            tails.append(h.peek(st.tail))
            p = self.pendings[i]
            if len(p) != st.phase:
                raise ValueError(
                    f"{st.name}: pool phase {len(p)} != steady {st.phase}"
                )
            pends.append(p.peek(st.phase))  # exactly (phase, cout)
        return {"tails": tails, "pendings": pends, "gap": self.gap.copy()}

    def import_steady(self, tails, pendings, gap, frames: int) -> None:
        for i, st in enumerate(self.plan.convs):
            self.hists[i].load(np.asarray(tails[i], np.int32))
            self.pendings[i].load(
                np.asarray(pendings[i][: st.phase], np.int32)
            )
            self.started[i] = True
        self.gap = np.asarray(gap, np.int64).copy()
        self.frames = frames


# ---------------------------------------------------------------------------
# Batched primer: warm up a mass join as ONE vectorized advance
# ---------------------------------------------------------------------------

def prime_batch(
    plan: StreamPlan,
    weights: dict[int, np.ndarray],
    thresholds: dict[int, tuple[np.ndarray, np.ndarray]],
    samples: np.ndarray,
) -> dict[str, list[np.ndarray] | np.ndarray | int]:
    """Warm up B fresh streams with one batched numpy advance.

    ``samples`` is (B, prime_samples) u8 codes.  Returns the batched
    steady-state interchange: ``tails[i]`` (B, tail_i, cin_i),
    ``pendings[i]`` (B, phase_i, cout_i), ``gap`` (B, C) int64 and the
    scalar ``frames`` every primed stream has emitted — row ``j`` equals
    ``StreamState().advance(samples[j]); export_steady()`` exactly.  The
    warm-up is integer arithmetic end to end (int64 conv accumulation,
    integer SA thresholds, OR-pooling), so adding the batch axis cannot
    change any value; bit-exactness is pinned by tests/test_rebalance.py.

    This is what lets a B-stream mass join cost one vectorized cascade
    instead of B per-stream ``StreamState`` warm-ups (the last
    per-stream-python ingest edge the PR 4 arena left behind).
    """
    samples = np.asarray(samples)
    if samples.ndim != 2 or samples.shape[1] != plan.prime_samples:
        raise ValueError(
            f"prime_batch wants (B, {plan.prime_samples}) samples, "
            f"got {samples.shape}"
        )
    B = samples.shape[0]
    cur = samples.reshape(B, -1, plan.convs[0].cin).astype(np.int32)
    tails: list[np.ndarray] = []
    pendings: list[np.ndarray] = []
    for st in plan.convs:
        # left pad arrives with the first real frame, exactly like
        # StreamState._advance_once on a fresh stream
        pad_val = st.in_offset if st.in_bits > 1 else 0
        window = np.concatenate(
            [np.full((B, st.pad, st.cin), pad_val, np.int32), cur], axis=1
        )
        avail = window.shape[1]
        n_conv = (avail - st.k) // st.stride + 1 if avail >= st.k else 0
        if n_conv <= 0 or avail - n_conv * st.stride != st.tail:
            raise ValueError(
                f"{st.name}: priming prefix does not reach the steady "
                f"tail (plan prime_samples mismatch?)"
            )
        w = weights[st.layer_idx].reshape(st.k, st.cin, st.cout)
        x = window.astype(np.int64)
        if st.in_bits > 1:
            x = x - st.in_offset  # offset-binary input (pads carry the code)
        taps = np.stack(
            [
                x[:, t : t + (n_conv - 1) * st.stride + 1 : st.stride]
                for t in range(st.k)
            ],
            axis=1,
        )  # (B, K, n_conv, Cin)
        raw = np.einsum("bknc,kco->bno", taps, w.astype(np.int64))
        thr, flip = thresholds[st.layer_idx]
        ge = raw >= thr[None, None, :]
        y = np.where(flip[None, None, :], ~ge, ge).astype(np.int32)
        tails.append(window[:, n_conv * st.stride :])
        used = (n_conv // st.pool) * st.pool
        if n_conv - used != st.phase:
            raise ValueError(
                f"{st.name}: pool phase {n_conv - used} != steady "
                f"{st.phase} after priming"
            )
        pendings.append(y[:, used:])
        cur = y[:, :used].reshape(
            B, n_conv // st.pool, st.pool, st.cout
        ).max(axis=2)
    gap = cur.astype(np.int64).sum(axis=1)
    return {"tails": tails, "pendings": pendings, "gap": gap,
            "frames": cur.shape[1]}
