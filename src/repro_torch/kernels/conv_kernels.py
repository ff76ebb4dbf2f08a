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
  view is materialised;
* ``bnn_bitserial_step``: the integer codes ``(B, L_in, Cin)`` int32 and
  int8 ternary weights ``([M,] K, Cin, Cout)``; the raw sum is returned
  before the offset fold, which stays in ``ops.bitserial_conv1d_batched``;
* ``classifier_tail``: GAP counts ``(B, C)`` int32 and per fc layer int8
  weights ``([M,] Cin, Cout)``, float32 thresholds and int32 flips
  ``([M,] Cout)``.
* ``bnn_conv1d``: the packed unpadded input ``(L, Cw)`` int32 words and
  packed weight planes ``(K, Cw, Cout)``; the kernel reads rows outside
  ``[0, L)`` as the conv's zero padding, so neither a padded copy nor a
  tap view is materialised.

With a tenant pool, ``model_idx`` is a per-slot ``(B,)`` int32 pool row
(``ops`` expands the reference's per-block rule) and every weight operand
carries the leading ``M`` axis.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.quant import unpack_bits
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.hop_megakernel import (
    H100_SMS,
    MAX_SMEM,
    _check,
    _classifier,
    _contract,
    _sa,
    _sms,
)

SOURCE = "bnn_conv1d"
BITSERIAL_KERNEL = "bnn_bitserial_step"
CONV_STEP_KERNEL = "bnn_conv1d_step"
TAIL_KERNEL = "classifier_tail"
CONV_KERNEL = "bnn_conv1d"
THREADS = 256
#: B.6 launch shape: at most this many output channels per CTA, and
#: enough position blocks for about one CTA per SM of an H100
CONV_BN = 128
CONV_TARGET_CTAS = 132
MAX_FC = 8
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
    integer dot, with SA on the non-raw layers -> (B, n_out) int32."""
    def one(g, m):
        pick = lambda xs: tuple(_row(x, m) for x in xs)  # noqa: E731
        return _classifier(g, pick(fc_ws), pick(fc_thrs), pick(fc_flips),
                           tuple(out_raw))
    return _tenants(one, gap, model_idx)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

class _TailFc(ctypes.Structure):
    _fields_ = [("cin", ctypes.c_int), ("cout", ctypes.c_int),
                ("raw", ctypes.c_int), ("unused", ctypes.c_int),
                ("w", ctypes.c_void_p), ("thr", ctypes.c_void_p),
                ("flip", ctypes.c_void_p)]


class _TailParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("n_fc", "gap_c", "n_out",
                                            "buf_elems")] + [
        (n, ctypes.c_void_p) for n in ("gap", "out", "model_idx")] + [
        ("fc", _TailFc * MAX_FC)]


def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_bnn_ready", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bnn_conv1d_step_launch.argtypes = [P] * 7 + [I] * 10 + [P]
        lib.bnn_bitserial_step_launch.argtypes = [P] * 4 + [I] * 12 + [P]
        lib.classifier_tail_launch.argtypes = [P, I, I, I, P]
        lib.bnn_conv1d_launch.argtypes = [P] * 6 + [I] * 13 + [P]
        for fn in (lib.bnn_conv1d_step_launch, lib.bnn_bitserial_step_launch,
                   lib.classifier_tail_launch,
                   lib.classifier_tail_params_size, lib.bnn_conv1d_launch):
            fn.restype = I
        size = lib.classifier_tail_params_size()
        if size != ctypes.sizeof(_TailParams):
            raise RuntimeError(
                f"classifier parameter block is {size} bytes in CUDA, "
                f"{ctypes.sizeof(_TailParams)} in Python")
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


def _conv_step_cuda(x, wp, wn, thr, flip, model_idx, *, k, stride, l_out,
                    pool, mode):
    b, l_in, cw = x.shape
    lead = tuple(wp.shape[:-3])
    cout = wp.shape[-1]
    _check(x, "x", torch.int32, (b, l_in, cw))
    _check(wp, "wp", torch.int32, lead + (k, cw, cout))
    _check(wn, "wn", torch.int32, lead + (k, cw, cout))
    sa = mode == "sa"
    n_pos = l_out // pool if sa else l_out
    used = n_pos * pool if sa else l_out
    if used and (used - 1) * stride + k > l_in:
        raise ValueError(f"{used} positions of a k={k} stride={stride} "
                         f"conv need more than the window's {l_in} rows")
    if sa:
        _check(thr, "thr", torch.float32, (cout,))
        _check(flip, "flip", torch.int32, (cout,))
    mi = _model_rows(model_idx, b)
    out = torch.empty((b, n_pos, cout), dtype=torch.int32, device=x.device)
    _run(_lib().bnn_conv1d_step_launch, CONV_STEP_KERNEL, x.device,
         x.data_ptr(), wp.data_ptr(), wn.data_ptr(), _ptr(thr), _ptr(flip),
         mi, out.data_ptr(), b, l_in, cw, k, stride, cout, n_pos, pool,
         int(sa), THREADS)
    return out


def _tail_cuda(gap, fc_ws, fc_thrs, fc_flips, model_idx, *, out_raw):
    b, gap_c = gap.shape
    n_fc = len(fc_ws)
    if not 1 <= n_fc <= MAX_FC:
        raise ValueError(f"kernel takes 1..{MAX_FC} fc layers, got {n_fc}")
    _check(gap, "gap", torch.int32, (b, gap_c))
    p = _TailParams()
    p.n_fc, p.gap_c = n_fc, gap_c
    p.gap = gap.data_ptr()
    width = gap_c
    for j, raw in enumerate(out_raw):
        lead = tuple(fc_ws[j].shape[:-2])
        cin, cout = fc_ws[j].shape[-2:]
        if cin != width:
            raise ValueError(f"fc {j} takes {cin} inputs, gets {width}")
        f = p.fc[j]
        f.cin, f.cout, f.raw = cin, cout, int(raw)
        f.w = _check(fc_ws[j], f"fc_ws[{j}]", torch.int8, lead + (cin, cout))
        if not raw:
            f.thr = _check(fc_thrs[j], f"fc_thrs[{j}]", torch.float32,
                           lead + (cout,))
            f.flip = _check(fc_flips[j], f"fc_flips[{j}]", torch.int32,
                            lead + (cout,))
        width = cout
    p.model_idx = _model_rows(model_idx, b)
    p.n_out = width
    p.buf_elems = -(-max([gap_c] + [w.shape[-1] for w in fc_ws]) // 4) * 4
    smem = 2 * p.buf_elems * 4
    if smem > MAX_SMEM:
        raise ValueError(f"classifier needs {smem} B of shared memory, "
                         f"more than the {MAX_SMEM} B a block can have")
    out = torch.empty((b, width), dtype=torch.int32, device=gap.device)
    p.out = out.data_ptr()
    _run(_lib().classifier_tail_launch, TAIL_KERNEL, gap.device,
         ctypes.byref(p), b, THREADS, smem)
    return out


def conv1d_tiles(cw: int, k: int, stride: int, cout: int, n_pos: int,
                 pool: int) -> tuple[int, int, int, int]:
    """B.6's launch shape: ``(bn, bp, ty, smem bytes)`` -- output channels
    and pooled positions per CTA, thread rows, and the shared memory of
    the block's staged weight planes and input rows.  Halves ``bn`` (down
    to one warp) and then ``bp`` until the block fits."""
    bn = min(CONV_BN, -(-cout // 32) * 32)
    blocks = -(-cout // bn)
    ty = THREADS // bn
    bp = max(ty, min(16 * ty, -(-n_pos * blocks // CONV_TARGET_CTAS)))

    def smem(bn, bp):
        rows = (bp * pool - 1) * stride + k
        return 4 * (2 * k * cw * bn + rows * cw)

    while smem(bn, bp) > MAX_SMEM and bn > 32:
        bn //= 2
    while smem(bn, bp) > MAX_SMEM and bp > 1:
        bp //= 2
    if smem(bn, bp) > MAX_SMEM:
        raise ValueError(
            f"a k={k} conv over {cw} words needs {smem(bn, bp)} B of shared "
            f"memory at its smallest block, more than the {MAX_SMEM} B a "
            "block can have")
    return bn, bp, THREADS // bn, smem(bn, bp)


def _conv1d_cuda(x, wp, wn, thr, flip, *, k, stride, pad, l_out, pool,
                 mode):
    l_in, cw = x.shape
    cout = wp.shape[-1]
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
    n_pos = l_out // pool
    out = torch.empty((n_pos, cout), dtype=torch.int32, device=x.device)
    bn, bp, ty, smem = conv1d_tiles(cw, k, stride, cout, n_pos, pool)
    _run(_lib().bnn_conv1d_launch, CONV_KERNEL, x.device, x.data_ptr(),
         wp.data_ptr(), wn.data_ptr(), _ptr(thr), _ptr(flip),
         out.data_ptr(), l_in, cw, k, stride, pad, cout, n_pos, pool,
         int(sa), bn, bp, ty, smem)
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
                    mode: str = "raw") -> torch.Tensor:
    """B.4, ONE launch: the K-tap popcount conv of the packed window ``x``
    (B, L_in, Cw).  ``raw`` -> (B, l_out, Cout) int32; ``sa`` ->
    (B, l_out // pool, Cout) int32 {0,1}."""
    if mode not in ("raw", "sa"):
        raise ValueError(f"mode {mode!r}")
    if x.device.type == "cpu":
        dispatch.record(CONV_STEP_KERNEL)
        return conv_step_plain(x, wp, wn, thr, flip, model_idx, k=k,
                               stride=stride, l_out=l_out, pool=pool,
                               mode=mode)
    out = _conv_step_cuda(x, wp, wn, thr, flip, model_idx, k=k,
                          stride=stride, l_out=l_out, pool=pool, mode=mode)
    dispatch.record(CONV_STEP_KERNEL)
    return out


def classifier_tail(gap, fc_ws, fc_thrs, fc_flips, model_idx=None, *,
                    out_raw) -> torch.Tensor:
    """B.5, ONE launch: GAP counts (B, C) int32 -> (B, n_out) int32
    logits."""
    if gap.device.type == "cpu":
        dispatch.record(TAIL_KERNEL)
        return classifier_tail_plain(gap, fc_ws, fc_thrs, fc_flips,
                                     model_idx, out_raw=out_raw)
    out = _tail_cuda(gap, fc_ws, fc_thrs, fc_flips, model_idx,
                     out_raw=out_raw)
    dispatch.record(TAIL_KERNEL)
    return out


def bnn_conv1d(x, wp, wn, thr=None, flip=None, *, k: int, stride: int,
               pad: int, l_out: int, pool: int = 1, mode: str = "sa"
               ) -> torch.Tensor:
    """B.6, ONE launch: the single-stream fused conv -> SA -> OR-pool of
    the packed input ``x`` (L, Cw).  ``raw`` (pool 1) -> (l_out, Cout)
    int32; ``sa`` -> (l_out // pool, Cout) int32 {0,1}."""
    if mode not in ("raw", "sa"):
        raise ValueError(f"mode {mode!r}")
    if mode == "raw" and pool != 1:
        raise ValueError("raw mode has no SA output to pool")
    if x.device.type == "cpu":
        dispatch.record(CONV_KERNEL)
        return conv1d_plain(x, wp, wn, thr, flip, k=k, stride=stride,
                            pad=pad, l_out=l_out, pool=pool, mode=mode)
    out = _conv1d_cuda(x, wp, wn, thr, flip, k=k, stride=stride, pad=pad,
                       l_out=l_out, pool=pool, mode=mode)
    dispatch.record(CONV_KERNEL)
    return out
