"""Popcount conv kernels, CUDA on Hopper: the per-stage stream kernels --
the bit-serial first-layer step (B.3), the batched popcount conv step
(B.4) and the classifier tail (B.5) -- and the kernel library's
single-stream fused conv -> SA -> pool (B.6).

The port of the reference's Pallas kernels in
``repro/kernels/bnn_conv1d.py``: ``bnn_bitserial_step_packed``,
``bnn_conv1d_step_packed``, ``classifier_tail_packed`` and
``bnn_conv1d_packed``.  The per-stage stream backend launches one of the
two conv steps per conv stage and hop, one per ghost-flush conv and one
classifier tail on an emit hop or a peek; the kernel library's
``ops.bnn_conv1d`` launches B.6 once per layer.

Each kernel has two versions here:

* the CUDA kernel (``csrc/bnn_conv1d.cu``), launched on the current
  stream for CUDA tensors; a build or launch failure raises, there is no
  fallback;
* the plain PyTorch version (``*_plain``), which runs for CPU tensors;
  the tests and ``chip_smoke.py`` hold the kernel against it.

Operands are what ``kernels/ops.py`` prepares:

* ``bnn_conv1d_step``: the packed binary window ``(B, L_in, Cw)`` int32
  words and packed weight planes ``([M,] K, Cw, Cout)`` int32; the taps
  of output position ``p`` are window rows ``p * stride + t``, so no tap
  view is materialised.  The kernel reads the planes laid out for the
  1-bit tensor cores (:func:`prepare_step_weights`, once per model);
* ``bnn_bitserial_step``: the integer codes ``(B, L_in, Cin)`` int32 and
  int8 ternary weights ``([M,] K, Cin, Cout)``; the raw sum is returned
  before the offset fold, which stays in ``ops.bitserial_conv1d_batched``;
* ``classifier_tail``: GAP counts ``(B, C)`` int32 and per fc layer int8
  weights ``([M,] Cin, Cout)`` (or their :class:`TailWeights`, laid out
  once per model for the int8 tensor cores), float32 thresholds and int32
  flips ``([M,] Cout)``;
* ``bnn_conv1d``: the packed unpadded input ``(L, Cw)`` int32 words and
  packed weight planes ``(K, Cw, Cout)``; the kernel stages rows outside
  ``[0, L)`` as the conv's zero padding, so neither a padded copy nor a
  tap view is materialised.  It is B.4's kernel over blocks of one
  stream's positions and reads the planes in B.4's layout.

With a tenant pool, ``model_idx`` is a per-slot ``(B,)`` int32 pool row
(``ops`` expands the reference's per-block rule) and every weight operand
carries the leading ``M`` axis.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import NamedTuple

import torch

from repro_torch.core.quant import unpack_bits
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.hop_megakernel import (
    CTA_RESERVED_SMEM,
    H100_SMS,
    MAX_SMEM,
    MMA_K,
    MMA_N,
    SM_SMEM,
    _cdiv,
    _check,
    _classifier,
    _contract,
    _kp,
    _sa,
    _sms,
    fragment_layout,
    same_device,
)

SOURCE = "bnn_conv1d"
BITSERIAL_KERNEL = "bnn_bitserial_step"
CONV_STEP_KERNEL = "bnn_conv1d_step"
TAIL_KERNEL = "classifier_tail"
CONV_KERNEL = "bnn_conv1d"
THREADS = 256
MAX_FC = 8
#: B.4 launch shape: the slot blocks a CTA may take, and an MMA item's
#: shapes (n-tiles, m-tiles) in the order the card ranked them at a hop's
#: b1-b3 windows (NVIDIA H100 80GB HBM3, 700 W; PERF.md): (2, 2) first,
#: and no item of 8 tiles, whose 64 accumulators leave room for one CTA
#: an SM instead of two
STEP_SLOTS = (1, 2, 4, 8, 16, 32, 64)
STEP_ITEMS = ((2, 2), (4, 1), (1, 4), (2, 1), (1, 2), (1, 1))
WARPS = THREADS // 32
#: B.6 launch shape: the blocks of pooled positions a CTA may take
CONV_BLOCKS = (8, 16, 32, 64, 128, 256)
#: B.5 launch shape: the slot blocks a cluster may take (its rows of one
#: m16 tile), the CTAs a cluster may have (at most 8, the portable cluster
#: size), and room for the kernel's static shared memory (its pass list
#: and tenant rows, checked against the build at load)
TAIL_SLOTS = (2, 4, 8, 16)
TAIL_CLUSTERS = (1, 2, 4, 8)
TAIL_ROWS = 16
TAIL_STATIC_SMEM = 4096
#: B.3 launch shape: positions per thread (the largest that still gives
#: one CTA per SM is taken), and the most shared memory its weight words
#: may take before the channels are split into blocks
BITSERIAL_PPT = (4, 2, 1)
BITSERIAL_WEIGHT_SMEM = 64 * 1024


def code_mask(bits: int) -> int:
    """The low-``bits`` mask of a bit-serial code, as a C ``int``."""
    return (1 << bits) - 1 if bits < 32 else -1


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _row(w, mdl):
    """Pool row ``mdl`` of a pooled operand (the operand itself when
    unpooled or absent)."""
    return w if mdl is None or w is None else w[mdl]


def _tenants(fn, x: torch.Tensor, model_idx) -> torch.Tensor:
    """``fn(x, None)``, or with a per-slot ``model_idx`` each tenant's rows
    through ``fn(rows, tenant)``."""
    if model_idx is None:
        return fn(x, None)
    out = None
    for mdl in torch.unique(model_idx).tolist():
        rows = torch.nonzero(model_idx == mdl).reshape(-1)
        y = fn(x.index_select(0, rows), mdl)
        if out is None:
            out = y.new_empty((x.shape[0], *y.shape[1:]))
        out[rows] = y
    return out


def _taps_conv(x, w, k: int, stride: int, n_pos: int) -> torch.Tensor:
    """(b, L, c) -> (b, n_pos, cout): sum over taps t of rows
    ``p * stride + t`` times ``w[t]``, exact through float64."""
    span = (n_pos - 1) * stride + 1
    taps = torch.stack([x[:, t:t + span:stride] for t in range(k)], 1)
    return _contract("bknc,kco->bno", taps, w)


def bitserial_step_plain(x, w, model_idx=None, *, bits: int, stride: int,
                         l_out: int) -> torch.Tensor:
    """Plain version of B.3: ``sum_{t,c} (x & (2^bits - 1)) * w`` over
    each position's taps -> (B, l_out, Cout) int32 (offset not folded)."""
    codes = x & code_mask(bits)
    k = w.shape[-3]
    return _tenants(
        lambda xx, m: _taps_conv(xx, _row(w, m), k, stride, l_out), codes,
        model_idx)


def conv_step_plain(x, wp, wn, thr=None, flip=None, model_idx=None, *,
                    k: int, stride: int, l_out: int, pool: int = 1,
                    mode: str = "raw") -> torch.Tensor:
    """Plain version of B.4: ``popc(x & wp) - popc(x & wn)`` summed over
    taps and words is the {0,1} lanes against the ternary weights, so the
    words are unpacked and contracted.  ``raw`` -> (B, l_out, Cout) int32;
    ``sa`` -> (B, l_out // pool, Cout) int32 {0,1}: SA, flip, OR-pool."""
    lanes = unpack_bits(x)
    w = unpack_bits(wp, axis=-2) - unpack_bits(wn, axis=-2)
    raw = _tenants(
        lambda xx, m: _taps_conv(xx, _row(w, m), k, stride, l_out), lanes,
        model_idx)
    if mode == "raw":
        return raw
    y = _sa(raw, thr, flip)
    b, _, c = y.shape
    n = l_out // pool
    return y[:, :n * pool].reshape(b, n, pool, c).amax(2)


def conv1d_plain(x, wp, wn, thr=None, flip=None, *, k: int, stride: int,
                 pad: int, l_out: int, pool: int = 1, mode: str = "sa"
                 ) -> torch.Tensor:
    """Plain version of B.6: the single-stream conv is B.4's on a batch of
    one, over the input with ``pad`` zero rows at each end.  ``raw`` ->
    (l_out, Cout) int32; ``sa`` -> (l_out // pool, Cout) int32 {0,1}."""
    x = torch.nn.functional.pad(x, (0, 0, pad, pad))
    return conv_step_plain(x[None], wp, wn, thr, flip, k=k, stride=stride,
                           l_out=l_out, pool=pool, mode=mode)[0]


def classifier_tail_plain(gap, fc_ws, fc_thrs, fc_flips, model_idx=None, *,
                          out_raw) -> torch.Tensor:
    """Plain version of B.5: ``min(gap, 255)``, then each fc layer's
    integer dot, with SA on the non-raw layers -> (B, n_out) int32.
    ``fc_ws`` may be a :class:`TailWeights` (its raw weights are read)."""
    if isinstance(fc_ws, TailWeights):
        fc_ws = fc_ws.ws

    def one(g, m):
        pick = lambda xs: tuple(_row(x, m) for x in xs)  # noqa: E731
        return _classifier(g, pick(fc_ws), pick(fc_thrs), pick(fc_flips),
                           tuple(out_raw))
    return _tenants(one, gap, model_idx)


# ---------------------------------------------------------------------------
# Weight layouts of the tensor-core kernels (B.4 and B.6, B.5)
# ---------------------------------------------------------------------------

def prepare_step_weights(wp, wn) -> torch.Tensor:
    """B.4's and B.6's weights from the packed planes ``([M,] K, Cw, Cout)``
    int32, in
    the B-fragment order of the 1-bit ``mma.m16n8k256``: ``([M,]
    ceil(Cout / 8), ceil(K * Cw / 8), 32, 4)`` int32, where lane ``4 g + t``
    of n-tile ``j`` and k-step ``s`` holds depth words ``8 s + t`` and
    ``8 s + 4 + t`` of column ``8 j + g``, first of ``wp``, then of ``wn``.
    Depth word ``d = Cw t' + c`` is word ``c`` of tap ``t'``, the order of
    a position's run of window words; words past ``K * Cw`` and columns
    past Cout are zero."""
    *lead, k, cw, cout = wp.shape
    ks, nt = _cdiv(k * cw, 8), _cdiv(cout, MMA_N)

    def order(plane):
        full = plane.new_zeros((*lead, ks * 8, nt * MMA_N))
        full[..., :k * cw, :cout] = plane.reshape(*lead, k * cw, cout)
        x = full.reshape(*lead, ks, 2, 4, nt, MMA_N)   # s h t j g
        nl = len(lead)
        perm = [*range(nl)] + [nl + i for i in (3, 0, 4, 2, 1)]
        return x.permute(perm).reshape(*lead, nt, ks, 32, 2)

    return torch.cat([order(wp), order(wn)], -1).contiguous()


@dataclasses.dataclass(frozen=True)
class TailWeights:
    """The fc weights of one model laid out once for B.5: ``ws`` the int8
    ``([M,] Cin, Cout)`` weights (which the plain version reads), ``frag``
    the same in fragment order ``([M,] ceil(Cout / 8), ceil(Cin / 32), 32,
    8)``."""

    ws: tuple
    frag: tuple


def prepare_tail_weights(fc_ws) -> TailWeights:
    """Lay out int8 fc weights ``([M,] Cin, Cout)`` for B.5 (on their own
    device).  The per-stage scheduler does this once per model."""
    ws = tuple(fc_ws)
    return TailWeights(ws, tuple(fragment_layout(w.transpose(-1, -2))
                                 for w in ws))


#: layouts made for callers that pass raw weights, by the id of the first
#: source tensor: (weak reference to it, ids and versions of the sources,
#: layout)
_LAYOUTS: dict[int, tuple] = {}


def _memo_layout(srcs, make):
    """``make()`` for the raw weight tensors ``srcs``, made once per tensor:
    kept while ``srcs[0]`` lives, and made again when a source is another
    object or was changed in place."""
    key = id(srcs[0])
    state = tuple((id(t), t._version) for t in srcs)
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0]() is srcs[0] and hit[1] == state:
        return hit[2]
    out = make()
    _LAYOUTS[key] = (weakref.ref(srcs[0], lambda _, k=key, d=_LAYOUTS:
                                 d.pop(k, None)), state, out)
    return out


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

class _StepArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "wf", "thr", "flip", "model_idx", "out")] + [
        (n, ctypes.c_int) for n in (
            "batch", "l_in", "cw", "k", "stride", "cout", "n_out", "pool",
            "sa", "slots", "ntb", "rows_in", "win_words", "pad")]


class _TailFc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("cin", "cout", "raw", "ksteps",
                                            "n_tiles", "unused")] + [
        ("w", ctypes.c_void_p), ("thr", ctypes.c_void_p),
        ("flip", ctypes.c_void_p)]


class _TailParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_fc", "gap_c", "n_out", "batch", "slots", "pitch", "ring_bytes",
        "cluster", "sa_cols", "n_sa")] + [
        (n, ctypes.c_void_p) for n in ("gap", "out", "model_idx")] + [
        ("fc", _TailFc * MAX_FC)]


def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_bnn_ready", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bnn_conv1d_step_launch.argtypes = [P, I, I, I, P]
        lib.bnn_bitserial_step_launch.argtypes = [P] * 4 + [I] * 12 + [P]
        lib.classifier_tail_launch.argtypes = [P, I, P]
        lib.bnn_conv1d_launch.argtypes = [P, I, I, I, P]
        for fn in (lib.bnn_conv1d_step_launch, lib.bnn_bitserial_step_launch,
                   lib.classifier_tail_launch,
                   lib.classifier_tail_params_size,
                   lib.bnn_conv1d_step_args_size,
                   lib.classifier_tail_static_smem, lib.bnn_conv1d_launch):
            fn.restype = I
        for what, size, struct in (
                ("classifier parameter block",
                 lib.classifier_tail_params_size(), _TailParams),
                ("conv step argument block", lib.bnn_conv1d_step_args_size(),
                 _StepArgs)):
            if size != ctypes.sizeof(struct):
                raise RuntimeError(f"{what} is {size} bytes in CUDA, "
                                   f"{ctypes.sizeof(struct)} in Python")
        static = lib.classifier_tail_static_smem()
        if not 0 <= static <= TAIL_STATIC_SMEM:
            raise RuntimeError(f"classifier kernel has {static} B of static "
                               f"shared memory; the layout leaves "
                               f"{TAIL_STATIC_SMEM} B")
        lib._bnn_ready = True
    return lib


def _run(launch, name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _aligned(ptr: int, name: str) -> int:
    """``ptr``, which the kernels copy 16 bytes at a time."""
    if ptr % 16:
        raise ValueError(f"{name}: the kernel copies it 16 bytes at a "
                         "time, so it must start on 16 bytes")
    return ptr


def _model_rows(model_idx, b: int) -> int | None:
    if model_idx is None:
        return None
    return _check(model_idx, "model_idx", torch.int32, (b,))


class BitserialTile(NamedTuple):
    """B.3's launch shape: positions per thread, positions and channels
    per CTA, and the CTA's shared memory (weight words + window bytes)."""

    ppt: int
    pb: int
    cb: int
    smem: int


def bitserial_tiles(b: int, l_out: int, cin: int, k: int, stride: int,
                    cout: int, sms: int = H100_SMS) -> BitserialTile:
    """B.3's launch shape.  A CTA's 256 threads cover ``cb`` channels (all
    of them, unless their weight words pass ``BITSERIAL_WEIGHT_SMEM``) in
    groups of 4, and as many position groups as that leaves; each thread
    takes the most positions of ``BITSERIAL_PPT`` that still gives ``sms``
    CTAs, so B=256 hops and a single long utterance both fill the SMs."""
    kw = -(-k * cin // 4)
    cb = -(-cout // 4) * 4
    cb = max(4, min(cb, BITSERIAL_WEIGHT_SMEM // (16 * kw) * 4))
    groups = max(1, THREADS // (cb // 4))
    cblocks = -(-cout // cb)
    ppt = BITSERIAL_PPT[-1]
    for cand in BITSERIAL_PPT:
        if b * -(-l_out // (groups * cand)) * cblocks >= sms:
            ppt = cand
            break

    def smem(pb):
        rows = (min(pb, l_out) - 1) * stride + k
        return kw * cb * 4 + -(-rows * cin // 4) * 4 + 8

    pb = groups * ppt
    while smem(pb) > MAX_SMEM and pb > 1:
        pb = max(1, pb // 2)
        ppt = min(ppt, pb)
    if smem(pb) > MAX_SMEM:
        raise ValueError(f"a k={k} cin={cin} bit-serial conv needs "
                         f"{smem(pb)} B of shared memory at its smallest "
                         f"block, more than the {MAX_SMEM} B a block can "
                         "have")
    return BitserialTile(ppt, pb, cb, smem(pb))


def _bitserial_cuda(x, w, model_idx, *, bits, stride, l_out):
    if bits > 8:
        raise ValueError("the bit-serial kernel stages the masked codes as "
                         "bytes, so it takes bits <= 8")
    b, l_in, cin = x.shape
    lead = tuple(w.shape[:-3])
    k, cout = w.shape[-3], w.shape[-1]
    same_device(x.device, w, model_idx)
    _check(x, "x", torch.int32, (b, l_in, cin))
    _check(w, "w", torch.int8, lead + (k, cin, cout))
    if (l_out - 1) * stride + k > l_in:
        raise ValueError(f"{l_out} positions of a k={k} stride={stride} "
                         f"conv need more than the window's {l_in} rows")
    mi = _model_rows(model_idx, b)
    out = torch.empty((b, l_out, cout), dtype=torch.int32, device=x.device)
    t = bitserial_tiles(b, l_out, cin, k, stride, cout, _sms(x.device))
    if -(-l_out // t.pb) > 65535 or -(-cout // t.cb) > 65535:
        raise ValueError(f"{l_out} positions x {cout} channels need more "
                         "than 65,535 blocks of either")
    _run(_lib().bnn_bitserial_step_launch, BITSERIAL_KERNEL, x.device,
         x.data_ptr(), w.data_ptr(), mi, out.data_ptr(), b, l_in, cin, k,
         stride, cout, l_out, code_mask(bits), t.ppt, t.pb, t.cb, t.smem)
    return out


class StepTile(NamedTuple):
    """B.4's launch shape: slots and n-tiles (8 output channels each) per
    CTA, an MMA item's n-tiles and m-tiles, and the CTA's shared memory
    (:func:`step_smem`)."""

    slots: int
    ntb: int
    ng: int
    mc: int
    smem: int


def step_rows(n_out: int, pool: int, stride: int, k: int) -> int:
    """Window rows B.4 reads per slot for ``n_out`` outputs of ``pool``
    positions each (pool 1 in ``raw`` mode)."""
    return (n_out * pool - 1) * stride + k


def step_win_words(rows_in: int, cw: int) -> int:
    """Words of shared memory a slot's packed rows take: the rows, then 8
    words of slack (a position's last k-step reads up to 7 words past its
    depth run, against zero weights), rounded up to 16 bytes."""
    return -(-(rows_in * cw + 8) // 4) * 4


def step_smem(slots: int, ntb: int, cw: int, k: int, rows_in: int) -> int:
    """B.4's shared memory for a CTA of ``slots`` slots (at most the batch)
    and ``ntb`` n-tiles: the n-tiles' weights in fragment order (512 bytes
    per n-tile and k-step), then each slot's packed rows."""
    return (ntb * _cdiv(k * cw, 8) * 512
            + slots * 4 * step_win_words(rows_in, cw))


def step_item(rows: int, ntb: int) -> tuple[int, int]:
    """An MMA item's ``(n-tiles, m-tiles)`` for a CTA of ``rows`` output
    rows and ``ntb`` n-tiles: the first of ``STEP_ITEMS`` that fits the
    CTA and still gives every warp an item, else the one that gives the
    most items."""
    mts = _cdiv(rows, 16)
    fits = [(ng, mc) for ng, mc in STEP_ITEMS if ng <= ntb and mc <= mts]
    for ng, mc in fits:
        if _cdiv(mts, mc) * _cdiv(ntb, ng) >= WARPS:
            return ng, mc
    return max(fits, key=lambda it: _cdiv(mts, it[1]) * _cdiv(ntb, it[0]))


def _rank(ctas: int, rows: int, ntb: int, l2: int, smem: int, sms: int):
    """The ranking key of a B.4 or B.6 launch shape of ``ctas`` CTAs, each
    of ``rows`` output rows and ``ntb`` n-tiles, reading ``l2`` bytes in
    all and holding ``smem`` bytes of shared memory, and its MMA item:
    how far the CTA count lies from one or two CTAs for every SM (two,
    where they fit), the MMA tiles on the busiest SM (an item past a CTA's
    last n-tile or row computes padding), the L2 bytes, the shared
    memory."""
    per_sm = min(2, SM_SMEM // (smem + CTA_RESERVED_SMEM))
    miss = sms - ctas if ctas < sms else max(0, ctas - sms * per_sm)
    ng, mc = step_item(rows, ntb)
    busiest = _cdiv(ctas, sms) * _cdiv(ntb, ng) * ng * \
        _cdiv(_cdiv(rows, 16), mc) * mc
    return (miss, busiest, l2, smem), (ng, mc)


@functools.lru_cache(maxsize=256)
def conv_step_tiles(b: int, cw: int, k: int, stride: int, cout: int,
                    n_out: int, pool: int = 1, pooled: bool = False,
                    sms: int = H100_SMS) -> StepTile:
    """B.4's launch shape for ``b`` slots of ``n_out`` outputs, among the
    blocks of ``STEP_SLOTS`` slots (one slot when the weights are a pool,
    so a CTA reads one pool row) and of ``ceil(n_tiles / 2^i)`` n-tiles
    that fit in shared memory.  The rule, from the card's sweep of every
    block at a hop's windows (``PERF.md``): one or two CTAs for every SM
    (two, where they fit, hide each other's loads and stores; the CTA
    count nearest that range when none is in it), then the fewest MMA
    tiles on the busiest SM (an item past a CTA's last n-tile or row
    computes padding), then the fewest bytes read from L2 (each CTA's
    weights and packed windows), then the least shared memory.  Memoized:
    a hop asks for the same few shapes every time."""
    nt, ks = _cdiv(cout, MMA_N), _cdiv(k * cw, 8)
    rows_in = step_rows(n_out, pool, stride, k)
    ntbs = sorted({_cdiv(nt, 1 << i) for i in range(nt.bit_length() + 1)})
    best = None
    for slots in (1,) if pooled else STEP_SLOTS:
        if slots > 1 and slots // 2 >= b:
            break
        rows = min(slots, b) * n_out
        for ntb in ntbs:
            smem = step_smem(min(slots, b), ntb, cw, k, rows_in)
            if smem > MAX_SMEM:
                continue
            ctas = _cdiv(b, slots) * _cdiv(nt, ntb)
            l2 = ctas * (ntb * ks * 512 + min(slots, b) * rows_in * cw * 4)
            key, item = _rank(ctas, rows, ntb, l2, smem, sms)
            if best is None or key < best[0]:
                best = (key, StepTile(slots, ntb, *item, smem))
    if best is None:
        raise ValueError(
            f"a k={k} conv step over {cw} words needs "
            f"{step_smem(1, 1, cw, k, rows_in)} B of shared memory at its "
            f"smallest block, more than the {MAX_SMEM} B a block can have")
    return best[1]


def _conv_step_cuda(x, wp, wn, thr, flip, model_idx, *, k, stride, l_out,
                    pool, mode, wf=None, tile=None):
    b, l_in, cw = x.shape
    lead = tuple(wp.shape[:-3])
    cout = wp.shape[-1]
    same_device(x.device, wp, wn, thr, flip, model_idx, wf)
    _check(x, "x", torch.int32, (b, l_in, cw))
    _check(wp, "wp", torch.int32, lead + (k, cw, cout))
    _check(wn, "wn", torch.int32, lead + (k, cw, cout))
    sa = mode == "sa"
    npool = pool if sa else 1
    n_out = l_out // pool if sa else l_out
    if n_out and step_rows(n_out, npool, stride, k) > l_in:
        raise ValueError(f"{n_out * npool} positions of a k={k} "
                         f"stride={stride} conv need more than the "
                         f"window's {l_in} rows")
    if sa:
        _check(thr, "thr", torch.float32, (cout,))
        _check(flip, "flip", torch.int32, (cout,))
    if wf is None:
        wf = _memo_layout((wp, wn), lambda: prepare_step_weights(wp, wn))
    _aligned(_check(wf, "wf", torch.int32,
                    lead + (_cdiv(cout, MMA_N), _cdiv(k * cw, 8), 32, 4)),
             "wf")
    mi = _model_rows(model_idx, b)
    out = torch.empty((b, n_out, cout), dtype=torch.int32, device=x.device)
    if tile is None:
        tile = conv_step_tiles(b, cw, k, stride, cout, n_out, npool,
                               mi is not None, _sms(x.device))
    if mi is not None and tile.slots != 1:
        raise ValueError("with a weight pool a CTA takes one slot")
    if (tile.ng, tile.mc) not in STEP_ITEMS:
        raise ValueError(f"no kernel for items of {tile.ng} x {tile.mc} "
                         f"tiles; the kernel has {STEP_ITEMS}")
    rows_in = step_rows(n_out, npool, stride, k)
    a = _StepArgs(x=x.data_ptr(), wf=wf.data_ptr(), thr=_ptr(thr),
                  flip=_ptr(flip), model_idx=mi, out=out.data_ptr(),
                  batch=b, l_in=l_in, cw=cw, k=k, stride=stride, cout=cout,
                  n_out=n_out, pool=npool, sa=int(sa), slots=tile.slots,
                  ntb=tile.ntb, rows_in=rows_in,
                  win_words=step_win_words(rows_in, cw))
    _run(_lib().bnn_conv1d_step_launch, CONV_STEP_KERNEL, x.device,
         ctypes.byref(a), tile.ng, tile.mc, tile.smem)
    return out


class TailTile(NamedTuple):
    """B.5's launch shape: slots per cluster, CTAs per cluster (which
    split each layer's n-tiles), bytes per activation row, bytes of each of
    the weight ring's two slots, the columns of a CTA's share of the widest
    layer, and a CTA's dynamic shared memory."""

    slots: int
    cluster: int
    pitch: int
    ring_bytes: int
    sa_cols: int
    smem: int


def tail_share(n: int, parts: int, rank: int) -> tuple[int, int]:
    """CTA ``rank``'s share ``[lo, hi)`` of ``n`` n-tiles (or GAP columns)
    split over a cluster of ``parts`` CTAs, as the kernel splits them."""
    per = _cdiv(n, parts)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def tail_block(b: int, n_tiles: int, sms: int = H100_SMS
               ) -> tuple[int, int]:
    """B.5's ``(slots, CTAs)`` per cluster for ``b`` slots and a first
    layer of ``n_tiles`` n-tiles: the largest cluster of ``TAIL_CLUSTERS``
    (at most ``n_tiles`` CTAs), then the fewest slots of ``TAIL_SLOTS``,
    whose launch takes at most one CTA for every two SMs; else 16 slots
    and one CTA.  The card's sweep of every pair at B = 1, 64 and 256
    (``PERF.md``) placed the rule: splitting the weights over more CTAs
    shortens each CTA's chain of loads, and more CTAs than half the SMs
    made the clusters slower, not faster."""
    for cluster in sorted(TAIL_CLUSTERS, reverse=True):
        if cluster > n_tiles:
            continue
        for slots in TAIL_SLOTS:
            if _cdiv(b, slots) * cluster <= sms // 2:
                return slots, cluster
    return TAIL_SLOTS[-1], 1


def tail_tiles(b: int, fc_dims, slots: int | None = None,
               cluster: int | None = None, n_sa: int | None = None,
               sms: int = H100_SMS) -> TailTile:
    """B.5's launch shape (:func:`_tail_tiles`, memoized: a hop asks for
    the same shape every time)."""
    return _tail_tiles(b, tuple(map(tuple, fc_dims)), slots, cluster, n_sa,
                       sms)


@functools.lru_cache(maxsize=64)
def _tail_tiles(b: int, fc_dims, slots, cluster, n_sa, sms) -> TailTile:
    """B.5's launch shape for ``b`` slots through fc layers of ``(cin,
    cout)`` ``fc_dims``.  A cluster's slots are the rows of one m16 tile,
    and its CTAs split each layer's n-tiles; :func:`tail_block` picks both
    unless ``slots`` / ``cluster`` say otherwise.  Activation
    rows are as wide as the widest layer input rounded up to 32, plus 16
    bytes, which puts a fragment's 8 rows on distinct banks.  Each of the
    ring's two slots holds a CTA's whole share of its largest layer (so a
    layer is one chunk, and the next layer's share loads beside it), or
    what fits.  Shared memory: the ring, two buffers of 16 activation rows,
    a threshold and a flip per column of the CTA's widest share for each
    of the ``n_sa`` SA layers (all but the last, by default) and each slot
    (a tenant each, at most), a split-K partial sum per thread, and the
    CTA's share of the GAP counts as copied (int32)."""
    tiles = [(_cdiv(cout, MMA_N), _kp(cin) // MMA_K * 256)
             for cin, cout in fc_dims]
    rule = tail_block(b, tiles[0][0], sms)
    slots = rule[0] if slots is None else slots
    cluster = rule[1] if cluster is None else cluster
    if slots not in TAIL_SLOTS:
        raise ValueError(f"a cluster takes one of {TAIL_SLOTS} slots, not "
                         f"{slots}")
    if cluster not in TAIL_CLUSTERS:
        raise ValueError(f"a cluster has one of {TAIL_CLUSTERS} CTAs, not "
                         f"{cluster}")
    pitch = _kp(max(cin for cin, _ in fc_dims)) + 16
    sa_cols = max(_cdiv(nt, cluster) * MMA_N for nt, _ in tiles)
    n_sa = len(fc_dims) - 1 if n_sa is None else n_sa
    acts = (2 * TAIL_ROWS * pitch + 8 * n_sa * slots * sa_cols
            + 4 * 4 * THREADS + 4 * slots * _cdiv(fc_dims[0][0], cluster))
    cap = (MAX_SMEM - TAIL_STATIC_SMEM - acts) // 2 // 256 * 256
    deepest = max(tile for _, tile in tiles)
    if cap < deepest:
        raise ValueError(f"the classifier needs {acts + 2 * deepest} B of "
                         f"shared memory at its smallest chunk, more than "
                         f"the {MAX_SMEM - TAIL_STATIC_SMEM} B a block can "
                         "have")
    ring = min(cap, max(_cdiv(nt, cluster) * tile for nt, tile in tiles))
    return TailTile(slots, cluster, pitch, ring, sa_cols, 2 * ring + acts)


def _tail_cuda(gap, fc_ws, fc_thrs, fc_flips, model_idx, *, out_raw,
               slots=None, cluster=None):
    b, gap_c = gap.shape
    if isinstance(fc_ws, TailWeights):
        ws, frag = fc_ws.ws, fc_ws.frag
    else:
        ws = tuple(fc_ws)
        frag = tuple(_memo_layout((w,), lambda w=w: fragment_layout(
            w.transpose(-1, -2))) for w in ws)
    n_fc = len(ws)
    same_device(gap.device, *ws, *frag, *fc_thrs, *fc_flips, model_idx)
    if not 1 <= n_fc <= MAX_FC:
        raise ValueError(f"kernel takes 1..{MAX_FC} fc layers, got {n_fc}")
    if any(out_raw[:-1]):
        raise ValueError("the CUDA classifier feeds each fc layer's output "
                         "to the next as u8 SA bits: only the last fc "
                         "layer may be raw")
    _check(gap, "gap", torch.int32, (b, gap_c))
    p = _TailParams()
    p.n_fc, p.gap_c, p.batch = n_fc, gap_c, b
    p.gap = gap.data_ptr()
    width = gap_c
    dims = []
    for j, raw in enumerate(out_raw):
        lead = tuple(ws[j].shape[:-2])
        cin, cout = ws[j].shape[-2:]
        if cin != width:
            raise ValueError(f"fc {j} takes {cin} inputs, gets {width}")
        f = p.fc[j]
        f.cin, f.cout, f.raw = cin, cout, int(raw)
        f.ksteps, f.n_tiles = _kp(cin) // MMA_K, _cdiv(cout, MMA_N)
        _check(ws[j], f"fc_ws[{j}]", torch.int8, lead + (cin, cout))
        f.w = _aligned(_check(frag[j], f"fc layout {j}", torch.int8,
                              lead + (f.n_tiles, f.ksteps, 32, 8)),
                       f"fc layout {j}")
        if not raw:
            f.thr = _check(fc_thrs[j], f"fc_thrs[{j}]", torch.float32,
                           lead + (cout,))
            f.flip = _check(fc_flips[j], f"fc_flips[{j}]", torch.int32,
                            lead + (cout,))
        dims.append((cin, cout))
        width = cout
    t = tail_tiles(b, dims, slots, cluster, n_fc - sum(map(bool, out_raw)),
                   _sms(gap.device))
    p.model_idx = _model_rows(model_idx, b)
    p.n_sa = n_fc - sum(map(bool, out_raw))
    p.n_out, p.slots, p.cluster = width, t.slots, t.cluster
    p.pitch, p.ring_bytes, p.sa_cols = t.pitch, t.ring_bytes, t.sa_cols
    out = torch.empty((b, width), dtype=torch.int32, device=gap.device)
    p.out = out.data_ptr()
    _run(_lib().classifier_tail_launch, TAIL_KERNEL, gap.device,
         ctypes.byref(p), t.smem)
    return out


class BlockTile(NamedTuple):
    """B.6's launch shape: pooled positions and n-tiles (8 output channels
    each) per CTA, an MMA item's n-tiles and m-tiles, and the CTA's shared
    memory (:func:`block_smem`)."""

    pb: int
    ntb: int
    ng: int
    mc: int
    smem: int


def block_win_words(rows_in: int, cw: int) -> int:
    """Words of shared memory B.6's window takes: up to 3 words before its
    first row (the copy starts on the 16-byte boundary at or before it),
    the rows, then 8 words of slack (a position's last k-step reads up to 7
    words past its depth run, against zero weights), rounded up to 16
    bytes."""
    return -(-(3 + rows_in * cw + 8) // 4) * 4


def block_smem(pb: int, ntb: int, cw: int, k: int, stride: int,
               npool: int) -> int:
    """B.6's shared memory for a CTA of ``pb`` pooled positions (at most
    the stream's) and ``ntb`` n-tiles: the n-tiles' weights in fragment
    order (512 bytes per n-tile and k-step), then the positions' rows."""
    rows_in = step_rows(pb, npool, stride, k)
    return (ntb * _cdiv(k * cw, 8) * 512
            + 4 * block_win_words(rows_in, cw))


@functools.lru_cache(maxsize=64)
def conv_block_tiles(cw: int, k: int, stride: int, cout: int, n_pos: int,
                     npool: int = 1, sms: int = H100_SMS) -> BlockTile:
    """B.6's launch shape for one stream of ``n_pos`` pooled positions of
    ``npool`` positions each (1 in ``raw`` mode), among the blocks of
    ``CONV_BLOCKS`` positions and of ``ceil(n_tiles / 2^i)`` n-tiles that
    fit in shared memory.  The rule is B.4's (:func:`conv_step_tiles`) with
    position blocks in place of slot blocks: one or two CTAs for every SM,
    then the fewest MMA tiles on the busiest SM, then the fewest bytes read
    from L2, then the least shared memory.  The card's sweep of every
    shape at the utterance's b1-b3 (``chip_smoke.py``, NVIDIA H100 80GB
    HBM3, 700 W; ``PERF.md``) ranks its picks within 3 % of the fastest:
    b1 32 x 2 at 0.0028 ms (fastest 16 x 4, 0.0027), b2 64 x 1 at 0.0031
    (32 x 4, 0.0030), b3 16 x 3 at 0.0030 (32 x 3, 0.0030); the slowest,
    a few large CTAs, take 0.015-0.045 ms.  Memoized: an utterance asks
    for the same three shapes every time."""
    nt, ks = _cdiv(cout, MMA_N), _cdiv(k * cw, 8)
    ntbs = sorted({_cdiv(nt, 1 << i) for i in range(nt.bit_length() + 1)})
    best = None
    for pb in CONV_BLOCKS:
        if pb > CONV_BLOCKS[0] and pb // 2 >= n_pos:
            break
        rows = min(pb, n_pos)
        blocks = _cdiv(n_pos, pb)
        rows_in = step_rows(rows, npool, stride, k)
        for ntb in ntbs:
            smem = block_smem(rows, ntb, cw, k, stride, npool)
            if smem > MAX_SMEM:
                continue
            ctas = blocks * _cdiv(nt, ntb)
            l2 = ctas * (ntb * ks * 512 + rows_in * cw * 4)
            key, item = _rank(ctas, rows, ntb, l2, smem, sms)
            if best is None or key < best[0]:
                best = (key, BlockTile(pb, ntb, *item, smem))
    if best is None:
        raise ValueError(
            f"a k={k} conv over {cw} words needs "
            f"{block_smem(1, 1, cw, k, stride, npool)} B of shared memory "
            f"at its smallest block, more than the {MAX_SMEM} B a block can "
            "have")
    return best[1]


def _conv1d_cuda(x, wp, wn, thr, flip, *, k, stride, pad, l_out, pool,
                 mode, wf=None, tile=None):
    l_in, cw = x.shape
    cout = wp.shape[-1]
    same_device(x.device, wp, wn, thr, flip, wf)
    _check(x, "x", torch.int32, (l_in, cw))
    _check(wp, "wp", torch.int32, (k, cw, cout))
    _check(wn, "wn", torch.int32, (k, cw, cout))
    sa = mode == "sa"
    if (l_out - 1) * stride + k > l_in + 2 * pad:
        raise ValueError(f"{l_out} positions of a k={k} stride={stride} "
                         f"conv need more than {l_in} rows padded by {pad}")
    if sa:
        _check(thr, "thr", torch.float32, (cout,))
        _check(flip, "flip", torch.int32, (cout,))
    npool = pool if sa else 1
    n_pos = l_out // npool
    if wf is None:
        wf = _memo_layout((wp, wn), lambda: prepare_step_weights(wp, wn))
    _aligned(_check(wf, "wf", torch.int32,
                    (_cdiv(cout, MMA_N), _cdiv(k * cw, 8), 32, 4)), "wf")
    out = torch.empty((n_pos, cout), dtype=torch.int32, device=x.device)
    if tile is None:
        tile = conv_block_tiles(cw, k, stride, cout, n_pos, npool,
                                _sms(x.device))
    if (tile.ng, tile.mc) not in STEP_ITEMS:
        raise ValueError(f"no kernel for items of {tile.ng} x {tile.mc} "
                         f"tiles; the kernel has {STEP_ITEMS}")
    a = _StepArgs(x=x.data_ptr(), wf=wf.data_ptr(), thr=_ptr(thr),
                  flip=_ptr(flip), model_idx=None, out=out.data_ptr(),
                  batch=1, l_in=l_in, cw=cw, k=k, stride=stride, cout=cout,
                  n_out=n_pos, pool=npool, sa=int(sa), slots=tile.pb,
                  ntb=tile.ntb, pad=pad)
    _run(_lib().bnn_conv1d_launch, CONV_KERNEL, x.device, ctypes.byref(a),
         tile.ng, tile.mc, tile.smem)
    return out


# ---------------------------------------------------------------------------
# Entry points: CPU tensors take the plain version, CUDA tensors the kernel
# ---------------------------------------------------------------------------

def bnn_bitserial_step(x, w, model_idx=None, *, bits: int, stride: int,
                       l_out: int) -> torch.Tensor:
    """B.3, ONE launch: (B, l_out, Cout) int32 raw bit-serial conv of the
    codes ``x`` (B, L_in, Cin) int32, offset not folded."""
    if x.device.type == "cpu":
        dispatch.record(BITSERIAL_KERNEL)
        return bitserial_step_plain(x, w, model_idx, bits=bits,
                                    stride=stride, l_out=l_out)
    out = _bitserial_cuda(x, w, model_idx, bits=bits, stride=stride,
                          l_out=l_out)
    dispatch.record(BITSERIAL_KERNEL)
    return out


def bnn_conv1d_step(x, wp, wn, thr=None, flip=None, model_idx=None, *,
                    k: int, stride: int, l_out: int, pool: int = 1,
                    mode: str = "raw", wf=None) -> torch.Tensor:
    """B.4, ONE launch: the K-tap popcount conv of the packed window ``x``
    (B, L_in, Cw).  ``raw`` -> (B, l_out, Cout) int32; ``sa`` ->
    (B, l_out // pool, Cout) int32 {0,1}.  ``wf`` is the planes laid out
    by :func:`prepare_step_weights`, which a caller that runs every hop
    makes once; without it the kernel lays out ``wp``/``wn`` at their
    first use (memoized by tensor)."""
    if mode not in ("raw", "sa"):
        raise ValueError(f"mode {mode!r}")
    if x.device.type == "cpu":
        dispatch.record(CONV_STEP_KERNEL)
        return conv_step_plain(x, wp, wn, thr, flip, model_idx, k=k,
                               stride=stride, l_out=l_out, pool=pool,
                               mode=mode)
    out = _conv_step_cuda(x, wp, wn, thr, flip, model_idx, k=k,
                          stride=stride, l_out=l_out, pool=pool, mode=mode,
                          wf=wf)
    dispatch.record(CONV_STEP_KERNEL)
    return out


def classifier_tail(gap, fc_ws, fc_thrs, fc_flips, model_idx=None, *,
                    out_raw) -> torch.Tensor:
    """B.5, ONE launch: GAP counts (B, C) int32, >= 0 -> (B, n_out) int32
    logits.  ``fc_ws`` is the int8 fc weights or their
    :class:`TailWeights`; raw weights are laid out at their first use on
    the card (memoized by tensor)."""
    if gap.device.type == "cpu":
        dispatch.record(TAIL_KERNEL)
        return classifier_tail_plain(gap, fc_ws, fc_thrs, fc_flips,
                                     model_idx, out_raw=out_raw)
    out = _tail_cuda(gap, fc_ws, fc_thrs, fc_flips, model_idx,
                     out_raw=out_raw)
    dispatch.record(TAIL_KERNEL)
    return out


def bnn_conv1d(x, wp, wn, thr=None, flip=None, *, k: int, stride: int,
               pad: int, l_out: int, pool: int = 1, mode: str = "sa",
               wf=None) -> torch.Tensor:
    """B.6, ONE launch: the single-stream fused conv -> SA -> OR-pool of
    the packed input ``x`` (L, Cw).  ``raw`` (pool 1) -> (l_out, Cout)
    int32; ``sa`` -> (l_out // pool, Cout) int32 {0,1}.  ``wf`` is the
    planes laid out by :func:`prepare_step_weights` (B.4's layout), which a
    caller that runs every utterance makes once; without it the kernel
    lays out ``wp``/``wn`` at their first use (memoized by tensor)."""
    if mode not in ("raw", "sa"):
        raise ValueError(f"mode {mode!r}")
    if mode == "raw" and pool != 1:
        raise ValueError("raw mode has no SA output to pool")
    if x.device.type == "cpu":
        dispatch.record(CONV_KERNEL)
        return conv1d_plain(x, wp, wn, thr, flip, k=k, stride=stride,
                            pad=pad, l_out=l_out, pool=pool, mode=mode)
    out = _conv1d_cuda(x, wp, wn, thr, flip, k=k, stride=stride, pad=pad,
                       l_out=l_out, pool=pool, mode=mode, wf=wf)
    dispatch.record(CONV_KERNEL)
    return out
