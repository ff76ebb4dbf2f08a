"""Hop megakernel: one launch per streaming KWS hop, CUDA on Hopper.

The port of the reference's Pallas megakernel
(``repro/kernels/hop_megakernel.py``: ``hop_megakernel_packed`` and
``finalize_megakernel_packed``, body ``_megakernel``).  One fused launch
runs the whole hop for every slot: the bit-serial first layer, each conv
stage's K-tap conv, SA binarization and max-pool with the pool-phase
carry, the receptive-field tail carry, GAP accumulation saturated at 255,
the masked-slot merge, and — on emit hops — the ghost end-of-stream flush
and the fc classifier on the merged state.  ``finalize_megakernel_packed``
is the same kernel in peek mode: flush + classifier from resident state.

Two versions of the same function live here:

* the CUDA kernel (``csrc/hop_megakernel.cu``), launched on the current
  stream for CUDA tensors; a build or launch failure raises, there is no
  fallback.  A CTA takes a block of slots (:func:`slot_block` picks its
  size from the batch and the shared memory, :func:`cta_layout` lays it
  out), keeps their feature maps in shared memory and runs every conv
  stage and fc layer as a GEMM on the int8 tensor cores, over weights
  that :func:`prepare_hop_weights` lays out once and the CTA streams
  through a shared-memory ring;
* the plain PyTorch version (``hop_megakernel_plain`` /
  ``finalize_megakernel_plain``), the twin of ``_megakernel``.  It runs
  for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel
  against it.

The packed entry points take the reference's packed operands: one tail per
stage with ``tail > 0`` and one pending per stage with ``phase > 0``
(``kernels/ops.py`` filters the zero-width ones), int8 ternary weights
``([K,] k, cin, cout)`` (or a :class:`HopWeights`), float32 thresholds
and int32 flips ``([K,] C)``, and with a tenant pool a per-slot ``(B,)``
int32 model index.  Binary stages' state holds {0, 1} values, GAP counts
[0, 255] (the kernel keeps both as u8).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, dispatch

HOP_KERNEL = "hop_megakernel"
FINALIZE_KERNEL = "finalize_megakernel"
MAX_STAGES = 8
MAX_FC = 4
MAX_SMEM = 232448  # opt-in shared memory per block on H100 (227 KB)


@dataclasses.dataclass(frozen=True)
class StageGeom:
    """One conv stage's static geometry — the subset of the stream plan's
    ``ConvStage`` the kernel needs, so the kernel layer never imports the
    stream runtime.  ``n_in`` (frames consumed per hop) sizes the window."""

    k: int
    stride: int
    pad: int
    pool: int
    cin: int
    cout: int
    in_bits: int
    in_offset: int
    tail: int
    phase: int
    n_in: int
    n_conv: int
    n_out: int
    flush_in: int
    flush_conv: int
    flush_out: int


def stage_geom(st) -> StageGeom:
    """Build a :class:`StageGeom` from anything with ConvStage's fields."""
    return StageGeom(**{f.name: getattr(st, f.name)
                        for f in dataclasses.fields(StageGeom)})


# ---------------------------------------------------------------------------
# Plain PyTorch version (the twin of the reference's ``_megakernel``)
# ---------------------------------------------------------------------------

def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer contraction, exact: float64 holds every partial sum of these
    layers (all < 2^53), and CUDA has no int32 GEMM."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def _codes(g: StageGeom, window: torch.Tensor) -> torch.Tensor:
    """Bit-serial first layer: ``sum_b ((x >> b) & 1) << b`` over the
    ``in_bits`` planes is ``x & (2^in_bits - 1)``; minus the offset."""
    if g.in_bits > 1:
        return (window & ((1 << g.in_bits) - 1)) - g.in_offset
    return window


def _conv_raw(g: StageGeom, w, window, n_pos: int) -> torch.Tensor:
    """(b, L, cin) int32 window -> (b, n_pos, cout) int32 raw conv."""
    x = _codes(g, window)
    span = (n_pos - 1) * g.stride + 1
    taps = torch.stack([x[:, t:t + span:g.stride] for t in range(g.k)], 1)
    return _contract("bknc,kco->bno", taps, w)


def _sa(raw, thr, flip) -> torch.Tensor:
    """SA binarization: float32 compare (integer thresholds, maybe ±inf)
    xor the per-channel flip."""
    ge = raw.to(torch.float32) >= thr
    return (ge ^ (flip != 0)).to(torch.int32)


def _pool(frames, n_out: int, pool: int) -> torch.Tensor:
    b, _, c = frames.shape
    return frames[:, :n_out * pool].reshape(b, n_out, pool, c).amax(2)


def _gap_add(gap, cur) -> torch.Tensor:
    return torch.clamp(gap + cur.sum(1, dtype=torch.int32), max=255)


def _steady_cascade(geoms, cur, tails, pends, ws, thrs, flips):
    new_tails, new_pends = [], []
    for i, g in enumerate(geoms):
        window = torch.cat([tails[i], cur], 1)
        raw = _conv_raw(g, ws[i], window, g.n_conv)
        new_tails.append(window[:, g.n_conv * g.stride:])
        y = _sa(raw, thrs[i], flips[i])
        if g.pool > 1:
            frames = torch.cat([pends[i], y], 1)
            used = g.n_out * g.pool
            new_pends.append(frames[:, used:])
            cur = _pool(frames, g.n_out, g.pool)
        else:
            new_pends.append(pends[i])
            cur = y
    return cur, new_tails, new_pends


def _flush_cascade(geoms, tails, pends, gap, ws, thrs, flips):
    """Ghost end-of-stream flush -> saturated GAP counts."""
    b = gap.shape[0]
    cur = None
    for i, g in enumerate(geoms):
        pieces = [tails[i]]
        if cur is not None and g.flush_in:
            pieces.append(cur)
        if g.pad:
            pad_val = g.in_offset if g.in_bits > 1 else 0
            pieces.append(torch.full((b, g.pad, g.cin), pad_val,
                                     dtype=torch.int32, device=gap.device))
        if g.flush_conv > 0:
            y = _sa(_conv_raw(g, ws[i], torch.cat(pieces, 1), g.flush_conv),
                    thrs[i], flips[i])
        else:
            y = torch.zeros((b, 0, g.cout), dtype=torch.int32,
                            device=gap.device)
        cur = _pool(torch.cat([pends[i], y], 1), g.flush_out, g.pool)
    return _gap_add(gap, cur)


def _classifier(gap_f, fc_ws, fc_thrs, fc_flips, fc_raw) -> torch.Tensor:
    h = torch.clamp(gap_f, max=255)
    for w, thr, flip, raw_out in zip(fc_ws, fc_thrs, fc_flips, fc_raw):
        raw = _contract("bc,co->bo", h, w)
        h = raw if raw_out else _sa(raw, thr, flip)
    return h


def _full_state(geoms, tails, pendings, b, device):
    """Packed (non-zero-width only) tails/pendings -> one entry per stage."""
    ti, pi = iter(tails), iter(pendings)
    z = lambda n, c: torch.zeros((b, n, c), dtype=torch.int32,  # noqa: E731
                                 device=device)
    full_t = [next(ti) if g.tail else z(0, g.cin) for g in geoms]
    full_p = [next(pi) if g.phase else z(0, g.cout) for g in geoms]
    return full_t, full_p


def _one_model(audio, mask, tails, pends, gap, params, geoms, emit, fc_raw,
               finalize_only):
    ws, thrs, flips, fc_ws, fc_thrs, fc_flips = params
    if finalize_only:
        gap_f = _flush_cascade(geoms, tails, pends, gap, ws, thrs, flips)
        return None, None, None, _classifier(gap_f, fc_ws, fc_thrs,
                                             fc_flips, fc_raw)
    cur, new_tails, new_pends = _steady_cascade(
        geoms, audio, tails, pends, ws, thrs, flips)
    gap2 = _gap_add(gap, cur)
    m = mask != 0
    m3 = m[:, None, None]
    tails = [torch.where(m3, nt, t) for nt, t in zip(new_tails, tails)]
    pends = [torch.where(m3, npd, p) for npd, p in zip(new_pends, pends)]
    gap = torch.where(m[:, None], gap2, gap)
    logits = None
    if emit:
        gap_f = _flush_cascade(geoms, tails, pends, gap, ws, thrs, flips)
        logits = _classifier(gap_f, fc_ws, fc_thrs, fc_flips, fc_raw)
    return tails, pends, gap, logits


def _plain(audio, mask, tails, pendings, gap, params, model_idx, *, geoms,
           emit, fc_raw, finalize_only):
    b = gap.shape[0]
    full_t, full_p = _full_state(geoms, tails, pendings, b, gap.device)
    if model_idx is None:
        out = _one_model(audio, mask, full_t, full_p, gap, params, geoms,
                         emit, fc_raw, finalize_only)
    else:
        # tenant pool: each model's rows run with that model's weights
        out_t = [t.clone() for t in full_t]
        out_p = [p.clone() for p in full_p]
        out_g = gap.clone()
        out_l = None
        for mdl in torch.unique(model_idx).tolist():
            rows = torch.nonzero(model_idx == mdl).reshape(-1)
            sel = lambda x: None if x is None else x.index_select(0, rows)  # noqa: E731,E501
            t, p, g, lg = _one_model(
                sel(audio), sel(mask), [sel(t) for t in full_t],
                [sel(p) for p in full_p], sel(gap),
                tuple(tuple(x[mdl] for x in grp) for grp in params),
                geoms, emit, fc_raw, finalize_only)
            if t is not None:
                for dst, src in zip(out_t + out_p + [out_g], t + p + [g]):
                    dst[rows] = src
            if lg is not None:
                if out_l is None:
                    out_l = torch.empty((b, lg.shape[1]), dtype=torch.int32,
                                        device=gap.device)
                out_l[rows] = lg
        out = out_t, out_p, out_g, out_l
    tails_o, pends_o, gap_o, logits = out
    if finalize_only:
        return logits
    packed_t = tuple(t for g, t in zip(geoms, tails_o) if g.tail)
    packed_p = tuple(p for g, p in zip(geoms, pends_o) if g.phase)
    if emit:
        return packed_t, packed_p, gap_o, logits
    return packed_t, packed_p, gap_o


def hop_megakernel_plain(audio, mask, tails, pendings, gap, ws, thrs, flips,
                         fc_ws=(), fc_thrs=(), fc_flips=(), model_idx=None,
                         *, geoms, emit, fc_raw=(), out=None):
    """Plain PyTorch version of :func:`hop_megakernel_packed` (any
    device).  Returns ``(tails, pendings, gap[, logits])``; with ``out``
    the state (and logits, when ``out`` holds them) is copied into its
    tensors, which are returned."""
    params = (ws, thrs, flips, fc_ws, fc_thrs, fc_flips)
    res = _plain(audio, mask, tails, pendings, gap, params, model_idx,
                 geoms=geoms, emit=emit, fc_raw=fc_raw, finalize_only=False)
    if out is None:
        return res
    out_t, out_p, out_g, *out_l = out
    for dst, src in zip((*out_t, *out_p, out_g, *out_l),
                        (*res[0], *res[1], res[2], *res[3:])):
        dst.copy_(src)
    return (tuple(out_t), tuple(out_p), out_g, *(out_l or res[3:]))


def finalize_megakernel_plain(tails, pendings, gap, ws, thrs, flips, fc_ws,
                              fc_thrs, fc_flips, model_idx=None, *, geoms,
                              fc_raw):
    """Plain PyTorch version of :func:`finalize_megakernel_packed`."""
    params = (ws, thrs, flips, fc_ws, fc_thrs, fc_flips)
    return _plain(None, None, tails, pendings, gap, params, model_idx,
                  geoms=geoms, emit=True, fc_raw=fc_raw, finalize_only=True)


# ---------------------------------------------------------------------------
# Weight layout for the kernel's int8 tensor-core GEMMs
# ---------------------------------------------------------------------------

#: depth of one ``mma.m16n8k32`` step and width of one n-tile
MMA_K = 32
MMA_N = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fragment_layout(wt: torch.Tensor) -> torch.Tensor:
    """``([M,] n, K)`` int8 (one row per output column) -> the kernel's
    fragment order ``([M,] n_tiles, kp / 32, 32, 8)``: n padded to a
    multiple of 8 and K to a multiple of 32 with zeros; lane ``4 g + t``
    of n-tile ``j`` and k-step ``s`` holds columns ``wt[8 j + g, 32 s +
    4 t : +4]`` and ``wt[8 j + g, 32 s + 16 + 4 t : +4]``, the B fragment
    of ``mma.m16n8k32.row.col`` for that lane."""
    *lead, n, k = wt.shape
    nt, ks = _cdiv(n, MMA_N), _cdiv(k, MMA_K)
    full = wt.new_zeros((*lead, nt * MMA_N, ks * MMA_K))
    full[..., :n, :k] = wt
    x = full.reshape(*lead, nt, MMA_N, ks, 2, 4, 4)   # j g s h t e
    nl = len(lead)
    perm = [*range(nl)] + [nl + i for i in (0, 2, 1, 4, 3, 5)]
    return x.permute(perm).reshape(*lead, nt, ks, 32, 8).contiguous()


@dataclasses.dataclass(frozen=True)
class HopWeights:
    """A model's weights laid out once for the CUDA hop kernel.

    ``ws``/``fc_ws`` are the reference operands (int8 ``([K,] k, cin,
    cout)`` and ``([K,] cin, cout)``), which the plain version reads;
    ``conv``/``fc`` the same weights in :func:`fragment_layout` order with
    depth ``k * cin`` (tap-major, as the windows are) or ``cin``; ``wsum``
    each conv column's weight sum ``([K,] cout)`` int32, for the
    ``in_offset`` fold of a bit-serial stage."""

    ws: tuple
    fc_ws: tuple
    conv: tuple
    wsum: tuple
    fc: tuple


def prepare_hop_weights(ws, fc_ws=()) -> HopWeights:
    """Lay out int8 conv weights ``([K,] k, cin, cout)`` and fc weights
    ``([K,] cin, cout)`` for the kernel (on their own device).  The
    scheduler does this once per model (``prepared_model_params``), so a
    hop never re-lays out weights."""
    conv, wsum = [], []
    for w in ws:
        *lead, k, cin, cout = w.shape
        flat = w.reshape(*lead, k * cin, cout)
        conv.append(fragment_layout(flat.transpose(-1, -2)))
        wsum.append(flat.sum(-2, dtype=torch.int32).contiguous())
    fc = tuple(fragment_layout(w.transpose(-1, -2)) for w in fc_ws)
    return HopWeights(tuple(ws), tuple(fc_ws), tuple(conv), tuple(wsum), fc)


# ---------------------------------------------------------------------------
# The CUDA kernel: parameter block, shared-memory layout, launch
# ---------------------------------------------------------------------------

_INT_FIELDS = ("k", "stride", "pad", "pool", "cin", "cout", "in_bits",
               "in_offset", "tail", "phase", "n_in", "n_conv", "n_out",
               "flush_in", "flush_conv", "flush_out")
#: a CTA's threads, the most slots it takes, and the n-tiles of a weight
#: chunk it may stream (the largest that fits is taken)
THREADS = 256
MAX_SLOTS = 8
SLOT_BLOCKS = (1, 2, 4, 8)
CHUNK_TILES = (8, 4, 2, 1)
#: the classifier's one m-tile: slot s is its row s
FC_ROWS = 16
#: bytes past a window's last row that a padded-K A fragment may read
WINDOW_SLACK = 32
#: shared memory of one H100 SM, and what the runtime reserves per CTA
SM_SMEM = 233472
CTA_RESERVED_SMEM = 1024
#: room left beside the dynamic buffers for the kernel's static shared
#: memory (its pass list: 3,968 B; checked against the build at load)
STATIC_SMEM = 4096
#: what the dynamic buffers of one CTA may take
DYNAMIC_SMEM = MAX_SMEM - STATIC_SMEM
#: streaming multiprocessors of an H100 SXM, the default of the launch
#: shape functions (the wrappers pass the card's own count)
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _Stage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _INT_FIELDS + (
        "pitch", "kp", "n_tiles", "a_mode", "fpitch", "tail_sto",
        "pend_sto")] + [
        (n, ctypes.c_void_p) for n in ("tail_in", "tail_out", "pend_in",
                                       "pend_out", "w", "wsum", "thr",
                                       "flip")]


class _Fc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("cin", "cout", "raw", "kp",
                                            "n_tiles", "unused")] + [
        ("w", ctypes.c_void_p), ("thr", ctypes.c_void_p),
        ("flip", ctypes.c_void_p)]


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_stages", "n_fc", "emit", "finalize_only", "gap_c", "n_logits",
        "batch", "slots", "chunk_tiles", "ring_bytes", "win0_bytes",
        "bin_bytes", "frm_bytes", "slot_bytes", "fc_pitch", "stg_off",
        "audio_sto", "gap_sto", "sa_cols")] + [
        (n, ctypes.c_void_p) for n in ("audio", "mask", "gap_in", "gap_out",
                                       "logits", "model_idx")] + [
        ("st", _Stage * MAX_STAGES), ("fc", _Fc * MAX_FC)]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def window_pitch(g: StageGeom) -> int:
    """Bytes per row of a stage's window: ``cin``, or ``cin + 16`` when
    ``cin % 32 == 0``, which puts a fragment's 8 rows on distinct banks."""
    return g.cin + 16 if g.cin % 32 == 0 else g.cin


def frame_pitch(g: StageGeom) -> int:
    """Bytes per row of a stage's concat(pending, y) buffer: ``cout``
    rounded up to an odd number of 4-byte words, so the 8 rows of an MMA
    fragment store to distinct banks."""
    return (_cdiv(g.cout, 4) | 1) * 4


def a_mode(g: StageGeom) -> int:
    """How the kernel reads a stage's A fragments: 0 from padded rows,
    1 linear with 4-byte loads, 2 linear byte by byte (a position's first
    tap is not 4-byte aligned)."""
    if g.cin % 32 == 0:
        return 0
    return 1 if g.stride * g.cin % 4 == 0 else 2


def _kp(width: int) -> int:
    return _cdiv(width, MMA_K) * MMA_K


def state_offsets(geoms: tuple[StageGeom, ...], gap_c: int
                  ) -> tuple[int, tuple[int, ...], tuple[int, ...], int, int]:
    """Where a slot's staged input state lies, in int32 elements: ``(audio,
    tails, pendings, gap, total)``.  The kernel copies each slot's audio,
    tails, pendings and GAP counts into shared memory in one round at the
    start, so its cascade reads no global memory."""
    off = geoms[0].n_in * geoms[0].cin
    tails, pends = [], []
    for g in geoms:
        tails.append(off)
        off += g.tail * g.cin
    for g in geoms:
        pends.append(off)
        off += g.phase * g.cout
    return 0, tuple(tails), tuple(pends), off, off + gap_c


def smem_layout(geoms: tuple[StageGeom, ...], fc_dims, gap_c: int
                ) -> tuple[int, int, int, int, int]:
    """One slot's shared-memory buffers, in bytes: ``(win0, bin, frm,
    fc_pitch, slot_bytes)``.  The layer-0 window and the two ping-pong
    windows hold each stage's input as u8 rows of :func:`window_pitch`
    (with slack for a padded-K fragment), the frames buffer
    concat(pending, y) as int8 at :func:`frame_pitch`, each sized for the
    larger of the steady and the flush cascade; then the staged input
    state (:func:`state_offsets`).  ``fc_pitch`` is the row pitch of the
    classifier's activations (one row per slot, see :func:`cta_layout`)."""
    def rows(g):
        return g.tail + max(g.n_in, g.flush_in + g.pad)

    g0 = geoms[0]
    win0 = _round16(rows(g0) * window_pitch(g0) + WINDOW_SLACK)
    bin_ = 1
    for g in geoms[1:]:
        bin_ = max(bin_, rows(g) * window_pitch(g) + WINDOW_SLACK)
    gl = geoms[-1]
    bin_ = _round16(max(bin_, max(gl.n_out, gl.flush_out) * gl.cout))
    frm = _round16(max(1, max((g.phase + max(g.n_conv, g.flush_conv))
                              * frame_pitch(g) for g in geoms)))
    widths = [gap_c] + [d for dims in fc_dims for d in dims]
    fc_pitch = _kp(max(widths)) + 16
    state = _round16(4 * state_offsets(geoms, gap_c)[-1])
    return win0, bin_, frm, fc_pitch, win0 + 2 * bin_ + frm + state


def sa_columns(geoms, fc_dims) -> int:
    """Columns of the shared SA-parameter buffer: the widest layer."""
    return max([g.cout for g in geoms] + [c for _, c in fc_dims])


class CtaLayout(NamedTuple):
    """One CTA's launch shape: ``slots`` per CTA, ``chunk_tiles`` n-tiles
    per weight chunk, the bytes of each of the ring's two slots, of one
    slot's buffers, of each classifier buffer and of the SA-parameter
    buffer, and the total dynamic shared memory."""

    slots: int
    chunk_tiles: int
    ring_bytes: int
    slot_bytes: int
    fc_bytes: int
    sa_bytes: int
    smem: int


def cta_layout(geoms, fc_dims, gap_c: int, slots: int) -> CtaLayout:
    """The shared memory of a CTA of ``slots`` slots: two weight-ring
    slots, then the slots' buffers, then two classifier buffers of
    ``FC_ROWS`` rows, then one pass's SA parameters (threshold, flip and
    offset fold per column).  The ring takes the largest chunk of
    ``CHUNK_TILES`` that fits; raises ``ValueError`` when none does."""
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"a CTA takes 1..{MAX_SLOTS} slots, not {slots}")
    *_, fc_pitch, slot_bytes = smem_layout(geoms, fc_dims, gap_c)
    ksteps = max([_kp(g.k * g.cin) // MMA_K for g in geoms]
                 + [_kp(cin) // MMA_K for cin, _ in fc_dims])
    fc_bytes = FC_ROWS * fc_pitch
    sa_bytes = _round16(12 * sa_columns(geoms, fc_dims))
    for ct in CHUNK_TILES:
        ring = ct * ksteps * MMA_K * MMA_N
        smem = 2 * ring + slots * slot_bytes + 2 * fc_bytes + sa_bytes
        if smem <= DYNAMIC_SMEM:
            return CtaLayout(slots, ct, ring, slot_bytes, fc_bytes, sa_bytes,
                             smem)
    raise ValueError(
        f"a CTA of {slots} slots needs {smem} B of shared memory at its "
        f"smallest weight chunk, more than the {DYNAMIC_SMEM} B a block "
        f"can have beside the kernel's {STATIC_SMEM} B of static shared "
        "memory")


def slot_block(b: int, geoms, fc_dims, gap_c: int, sms: int = H100_SMS
               ) -> CtaLayout:
    """The launch shape for a batch of ``b`` slots: among the slot blocks
    of ``SLOT_BLOCKS`` that fit, the one with the fewest waves of CTAs over
    ``sms`` SMs (CTAs per SM from shared memory and threads), and of
    those the smallest, which spreads the MMAs over the most SMs."""
    best = None
    for s in SLOT_BLOCKS:
        try:
            lay = cta_layout(geoms, fc_dims, gap_c, s)
        except ValueError:
            continue
        per_sm = min(2048 // THREADS, SM_SMEM // (
            lay.smem + STATIC_SMEM + CTA_RESERVED_SMEM))
        waves = _cdiv(_cdiv(b, s), sms * max(per_sm, 1))
        if best is None or waves < best[0]:
            best = (waves, lay)
    if best is None:
        raise ValueError("no slot block fits this plan in shared memory")
    return best[1]


class LaunchShape(NamedTuple):
    """What a launch derives from the plan and the batch alone:
    :func:`state_offsets`, :func:`smem_layout`, :func:`sa_columns` and the
    CTA layout (:func:`slot_block`, or :func:`cta_layout` of a forced slot
    block)."""

    offsets: tuple
    smem: tuple
    sa_cols: int
    layout: CtaLayout


@functools.lru_cache(maxsize=256)
def _launch_shape(geoms, fc_dims, gap_c: int, b: int, sms: int,
                  slots: int | None) -> LaunchShape:
    """The launch shape of ``b`` slots, memoized: every hop of a capacity
    asks for the same one (S times a hop over S shards), and
    :func:`slot_block` lays out each slot block to pick one.  ``fc_dims``
    is a tuple of ``(cin, cout)`` pairs, empty on a steady hop."""
    lay = (slot_block(b, geoms, fc_dims, gap_c, sms) if slots is None
           else cta_layout(geoms, fc_dims, gap_c, slots))
    return LaunchShape(state_offsets(geoms, gap_c),
                       smem_layout(geoms, fc_dims, gap_c),
                       sa_columns(geoms, fc_dims), lay)


def _lib():
    lib = build.load(HOP_KERNEL)
    if not getattr(lib, "_hop_ready", False):
        lib.hop_megakernel_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.hop_megakernel_launch.restype = ctypes.c_int
        lib.hop_megakernel_params_size.restype = ctypes.c_int
        lib.hop_megakernel_static_smem.restype = ctypes.c_int
        size = lib.hop_megakernel_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"hop kernel parameter block is {size} bytes in CUDA, "
                f"{ctypes.sizeof(_Params)} in Python")
        static = lib.hop_megakernel_static_smem()
        if not 0 <= static <= STATIC_SMEM:
            raise RuntimeError(f"hop kernel has {static} B of static shared "
                               f"memory; the layout leaves {STATIC_SMEM} B")
        lib._hop_ready = True
    return lib


def _check(x: torch.Tensor, name: str, dtype, shape) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return x.data_ptr()


def same_device(dev: torch.device, *tensors) -> None:
    """Refuse, before any pointer is taken, a kernel operand on another
    device than the launch's (``dev``, under which the launch runs): a
    pointer into one card's memory must never reach a kernel on another.
    None entries (absent operands) are skipped."""
    for x in tensors:
        if x is not None and x.device != dev:
            raise ValueError(f"a kernel operand lies on {x.device} and the "
                             f"launch runs on {dev}")


def check_geoms(geoms, fc_raw) -> None:
    """Refuse, with the reason, the plans the kernel does not take."""
    ns, nf = len(geoms), len(fc_raw)
    if not 1 <= ns <= MAX_STAGES or nf > MAX_FC:
        raise ValueError(f"kernel takes 1..{MAX_STAGES} conv stages and at "
                         f"most {MAX_FC} fc layers; got {ns} and {nf}")
    if any(g.in_bits > 8 for g in geoms):
        # the windows hold u8 values: a bit-serial input's masked raw
        # value fits only for in_bits <= 8
        raise ValueError("the CUDA kernel feeds every conv stage's input "
                         "to the int8 tensor cores as u8, so a bit-serial "
                         "input must have in_bits <= 8")
    if any(fc_raw[:-1]):
        raise ValueError("the CUDA kernel feeds each fc layer's output to "
                         "the next as u8 SA bits: only the last fc layer "
                         "may be raw")


def _frag(x, name, lead, n, k):
    return _check(x, name, torch.int8,
                  lead + (_cdiv(n, MMA_N), _cdiv(k, MMA_K), 32, 8))


def _launch(audio, mask, tails, pendings, gap, ws, thrs, flips, fc_ws,
            fc_thrs, fc_flips, model_idx, *, geoms, emit, fc_raw,
            finalize_only, slots=None, out=None):
    check_geoms(geoms, fc_raw)
    hw = ws if isinstance(ws, HopWeights) else prepare_hop_weights(ws,
                                                                   fc_ws)
    ns, nf = len(geoms), len(fc_raw)
    b, gap_c = gap.shape
    dev = gap.device
    same_device(dev, audio, mask, *tails, *pendings, model_idx, *hw.conv,
                *hw.wsum, *hw.fc, *thrs, *flips, *fc_thrs, *fc_flips,
                *(() if out is None else (*out[0], *out[1], *out[2:])))
    pooled = model_idx is not None
    lead = (hw.ws[0].shape[0],) if pooled else ()
    p = _Params()
    p.n_stages, p.n_fc = ns, nf
    p.emit, p.finalize_only = int(emit), int(finalize_only)
    p.gap_c, p.batch = gap_c, b
    p.gap_in = _check(gap, "gap", torch.int32, (b, gap_c))
    if pooled:
        p.model_idx = _check(model_idx, "model_idx", torch.int32, (b,))
    if not finalize_only:
        g0 = geoms[0]
        p.audio = _check(audio, "audio", torch.int32, (b, g0.n_in, g0.cin))
        p.mask = _check(mask, "mask", torch.int32, (b,))
    ti = pi = 0
    tails_out, pends_out = [], []
    out_l = ()
    if out is not None:
        out_t, out_p, out_g, *out_l = out
        if len(out_t) != len(tails) or len(out_p) != len(pendings):
            raise ValueError("out does not match the stages' widths")
    with_fc = emit or finalize_only
    fc_dims = tuple((w.shape[-2], w.shape[-1]) for w in hw.fc_ws) \
        if with_fc else ()
    geo = _launch_shape(geoms, fc_dims, gap_c, b, _sms(dev), slots)
    p.audio_sto, tail_sto, pend_sto, p.gap_sto, _ = geo.offsets
    for i, g in enumerate(geoms):
        s = p.st[i]
        s.tail_sto, s.pend_sto = tail_sto[i], pend_sto[i]
        for f in _INT_FIELDS:
            setattr(s, f, getattr(g, f))
        s.pitch, s.a_mode = window_pitch(g), a_mode(g)
        s.fpitch = frame_pitch(g)
        s.kp, s.n_tiles = _kp(g.k * g.cin), _cdiv(g.cout, MMA_N)
        s.w = _frag(hw.conv[i], f"conv weights[{i}]", lead, g.cout,
                    g.k * g.cin)
        s.wsum = _check(hw.wsum[i], f"wsum[{i}]", torch.int32,
                        lead + (g.cout,))
        s.thr = _check(thrs[i], f"thrs[{i}]", torch.float32, lead + (g.cout,))
        s.flip = _check(flips[i], f"flips[{i}]", torch.int32, lead + (g.cout,))
        if g.tail:
            s.tail_in = _check(tails[ti], f"tails[{ti}]", torch.int32,
                               (b, g.tail, g.cin))
            ti += 1
            if not finalize_only:
                shape = (b, g.tail, g.cin)
                if out is None:
                    t = torch.empty(shape, dtype=torch.int32, device=dev)
                else:
                    t = out_t[ti - 1]
                    _check(t, f"out tails[{ti - 1}]", torch.int32, shape)
                s.tail_out = t.data_ptr()
                tails_out.append(t)
        if g.phase:
            s.pend_in = _check(pendings[pi], f"pendings[{pi}]", torch.int32,
                               (b, g.phase, g.cout))
            pi += 1
            if not finalize_only:
                shape = (b, g.phase, g.cout)
                if out is None:
                    t = torch.empty(shape, dtype=torch.int32, device=dev)
                else:
                    t = out_p[pi - 1]
                    _check(t, f"out pendings[{pi - 1}]", torch.int32, shape)
                s.pend_out = t.data_ptr()
                pends_out.append(t)
    if ti != len(tails) or pi != len(pendings):
        raise ValueError("tails/pendings do not match the stages' widths")
    if with_fc:
        if len(fc_dims) != nf:
            raise ValueError(f"{len(fc_dims)} fc weights for {nf} fc layers")
        width = gap_c
        for j, raw in enumerate(fc_raw):
            f = p.fc[j]
            cin, cout = fc_dims[j]
            if cin != width:
                raise ValueError(f"fc {j} takes {cin} inputs, gets {width}")
            f.cin, f.cout, f.raw = cin, cout, int(raw)
            f.kp, f.n_tiles = _kp(cin), _cdiv(cout, MMA_N)
            f.w = _frag(hw.fc[j], f"fc weights[{j}]", lead, cout, cin)
            if not raw:
                f.thr = _check(fc_thrs[j], f"fc_thrs[{j}]", torch.float32,
                               lead + (cout,))
                f.flip = _check(fc_flips[j], f"fc_flips[{j}]", torch.int32,
                                lead + (cout,))
            width = cout
        p.n_logits = width
        if out_l and not finalize_only:
            logits = out_l[0]
            _check(logits, "out logits", torch.int32, (b, p.n_logits))
        else:
            logits = torch.empty((b, p.n_logits), dtype=torch.int32,
                                 device=dev)
        p.logits = logits.data_ptr()
    else:
        p.n_fc = 0
    gap_out = None
    if not finalize_only:
        if out is None:
            gap_out = torch.empty((b, gap_c), dtype=torch.int32, device=dev)
        else:
            gap_out = out_g
            _check(gap_out, "out gap", torch.int32, (b, gap_c))
        p.gap_out = gap_out.data_ptr()
    (p.win0_bytes, p.bin_bytes, p.frm_bytes, p.fc_pitch,
     p.slot_bytes) = geo.smem
    p.stg_off = p.win0_bytes + 2 * p.bin_bytes + p.frm_bytes
    p.sa_cols = geo.sa_cols
    lay = geo.layout
    p.slots, p.chunk_tiles, p.ring_bytes = (lay.slots, lay.chunk_tiles,
                                            lay.ring_bytes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().hop_megakernel_launch(
            ctypes.byref(p), _cdiv(b, lay.slots), THREADS, lay.smem, stream)
    if rc != 0:
        raise RuntimeError(f"hop megakernel launch failed: CUDA error {rc}")
    if finalize_only:
        return logits
    if emit:
        return tuple(tails_out), tuple(pends_out), gap_out, logits
    return tuple(tails_out), tuple(pends_out), gap_out


def _raw_weights(ws, fc_ws):
    """The reference operands, from raw weights or a :class:`HopWeights`."""
    if isinstance(ws, HopWeights):
        return ws.ws, ws.fc_ws
    return ws, fc_ws


def hop_megakernel_packed(audio, mask, tails, pendings, gap, ws, thrs, flips,
                          fc_ws=(), fc_thrs=(), fc_flips=(), model_idx=None,
                          *, geoms, emit, fc_raw=(), out=None):
    """One fused hop, ONE launch: ``(tails, pendings, gap[, logits])``.

    ``ws`` is the int8 conv weights or a :class:`HopWeights` from
    :func:`prepare_hop_weights`, which also carries the fc weights (then
    ``fc_ws`` is not read).  ``out``, a packed ``(tails, pendings, gap)``
    shaped like the inputs and sharing no memory with them, receives the
    new state in place of fresh tensors (a caller that ping-pongs two
    state sets allocates nothing per hop).  For CUDA tensors this
    launches the CUDA kernel (and raises on any failure; raw weights are
    laid out first); for CPU tensors the plain version stands in for it.
    Either way it counts one ``hop_megakernel`` dispatch."""
    if gap.device.type == "cpu":
        dispatch.record(HOP_KERNEL)
        ws, fc_ws = _raw_weights(ws, fc_ws)
        return hop_megakernel_plain(
            audio, mask, tails, pendings, gap, ws, thrs, flips, fc_ws,
            fc_thrs, fc_flips, model_idx, geoms=geoms, emit=emit,
            fc_raw=fc_raw, out=out)
    res = _launch(audio, mask, tails, pendings, gap, ws, thrs, flips, fc_ws,
                  fc_thrs, fc_flips, model_idx, geoms=geoms, emit=emit,
                  fc_raw=fc_raw, finalize_only=False, out=out)
    dispatch.record(HOP_KERNEL)
    return res


def finalize_megakernel_packed(tails, pendings, gap, ws, thrs, flips, fc_ws,
                               fc_thrs, fc_flips, model_idx=None, *, geoms,
                               fc_raw):
    """Ghost flush + classifier from resident state, ONE launch: int32
    logits ``(B, n_classes)``.  ``ws`` as for :func:`hop_megakernel_packed`;
    CPU tensors take the plain version."""
    if gap.device.type == "cpu":
        dispatch.record(FINALIZE_KERNEL)
        ws, fc_ws = _raw_weights(ws, fc_ws)
        return finalize_megakernel_plain(
            tails, pendings, gap, ws, thrs, flips, fc_ws, fc_thrs, fc_flips,
            model_idx, geoms=geoms, fc_raw=fc_raw)
    out = _launch(None, None, tails, pendings, gap, ws, thrs, flips, fc_ws,
                  fc_thrs, fc_flips, model_idx, geoms=geoms, emit=True,
                  fc_raw=fc_raw, finalize_only=True)
    dispatch.record(FINALIZE_KERNEL)
    return out
