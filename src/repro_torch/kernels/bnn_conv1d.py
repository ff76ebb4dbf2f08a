"""Per-stage stream kernels, CUDA on Hopper: the bit-serial first-layer
step (B.3), the batched popcount conv step (B.4) and the classifier tail
(B.5).

The port of the reference's Pallas kernels in
``repro/kernels/bnn_conv1d.py``: ``bnn_bitserial_step_packed``,
``bnn_conv1d_step_packed`` and ``classifier_tail_packed``.  The
per-stage stream backend launches one of the two conv steps per conv
stage and hop, one per ghost-flush conv and one classifier tail on an
emit hop or a peek.

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

With a tenant pool, ``model_idx`` is a per-slot ``(B,)`` int32 pool row
(``ops`` expands the reference's per-block rule) and every weight operand
carries the leading ``M`` axis.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import unpack_bits
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.hop_megakernel import (
    MAX_SMEM,
    _check,
    _classifier,
    _contract,
    _sa,
)

SOURCE = "bnn_conv1d"
BITSERIAL_KERNEL = "bnn_bitserial_step"
CONV_STEP_KERNEL = "bnn_conv1d_step"
TAIL_KERNEL = "classifier_tail"
THREADS = 256
MAX_FC = 8


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
        lib.bnn_bitserial_step_launch.argtypes = [P] * 4 + [I] * 9 + [P]
        lib.classifier_tail_launch.argtypes = [P, I, I, I, P]
        for fn in (lib.bnn_conv1d_step_launch, lib.bnn_bitserial_step_launch,
                   lib.classifier_tail_launch,
                   lib.classifier_tail_params_size):
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


def _bitserial_cuda(x, w, model_idx, *, bits, stride, l_out):
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
    _run(_lib().bnn_bitserial_step_launch, BITSERIAL_KERNEL, x.device,
         x.data_ptr(), w.data_ptr(), mi, out.data_ptr(), b, l_in, cin, k,
         stride, cout, l_out, code_mask(bits), THREADS)
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
