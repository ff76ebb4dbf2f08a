"""The TWM macro read as a GEMM, CUDA on Hopper: the packed popcount GEMM
(B.7) and the int8 tensor-core GEMM (B.8), each with the SA epilogue.

The port of the reference's Pallas kernels in
``repro/kernels/twm_matmul.py``: ``twm_matmul`` (raw and ``sa``) and
``twm_matmul_mxu``.  The kernel library's dense entry points
(``ops.twm_linear``, ``ops.twm_linear_mxu``) launch one of them per
layer; ``ops.pick_path`` chooses between them from the shape.

Each kernel has two versions here:

* the CUDA kernel (``csrc/twm_matmul.cu``), launched on the current
  stream for CUDA tensors; a build or launch failure raises, there is no
  fallback;
* the plain PyTorch version (``*_plain``), which runs for CPU tensors;
  the tests and ``chip_smoke.py`` hold the kernel against it.

Operands are what ``kernels/ops.py`` prepares:

* ``twm_matmul``: packed activations ``(M, Kw)`` int32 words and packed
  weight planes ``(Kw, N)`` int32 (the reference's uint32 bit patterns),
  with ``thr`` float32 and ``flip`` int32 ``(N,)`` in ``sa`` mode;
* ``twm_matmul_mxu``: int8 activations ``(M, Kp)`` in {0, 1} and the
  int8 ternary weights transposed to ``(N, Kp)``, ``Kp`` zero-padded to a
  multiple of 32 (both K-contiguous, the layout of the int8 MMA), with
  ``thr``/``flip`` as above.

Both return ``(M, N)`` int32: the popcount difference in ``raw`` mode,
{0, 1} after the SA (``float(acc) >= thr`` xor ``flip``) otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import unpack_bits
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.conv_kernels import _run
from repro_torch.kernels.hop_megakernel import _check, _contract, _sa

SOURCE = "twm_matmul"
POPCOUNT_KERNEL = "twm_matmul"
MXU_KERNEL = "twm_matmul_mxu"
#: K granularity of the int8 MMA (m16n8k32)
MXU_K = 32
_MAX_GRID_Y = 65535
_TILE = 64


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def twm_matmul_plain(x, wp, wn, thr=None, flip=None, *, mode: str = "sa"
                     ) -> torch.Tensor:
    """Plain version of B.7: ``popc(x & wp) - popc(x & wn)`` summed over
    the words is the {0,1} lanes against the ternary weights, so the words
    are unpacked and contracted (exact through float64)."""
    lanes = unpack_bits(x)
    w = unpack_bits(wp, axis=0) - unpack_bits(wn, axis=0)
    raw = _contract("mk,kn->mn", lanes, w)
    return raw if mode == "raw" else _sa(raw, thr, flip)


def twm_matmul_mxu_plain(x, wt, thr, flip) -> torch.Tensor:
    """Plain version of B.8: ``x @ w`` in float64, then the SA."""
    acc = (x.double() @ wt.double().t()).to(torch.int32)
    return _sa(acc, thr, flip)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_twm_ready", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.twm_matmul_launch.argtypes = [P] * 6 + [I] * 4 + [P]
        lib.twm_matmul_mxu_launch.argtypes = [P] * 5 + [I] * 3 + [P]
        for fn in (lib.twm_matmul_launch, lib.twm_matmul_mxu_launch):
            fn.restype = I
        lib._twm_ready = True
    return lib


def _grid_rows(m: int) -> None:
    if -(-m // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"{m} rows exceed the kernel grid "
                         f"({_MAX_GRID_Y} tiles of {_TILE})")


def _sa_params(thr, flip, n: int):
    return (_check(thr, "thr", torch.float32, (n,)),
            _check(flip, "flip", torch.int32, (n,)))


def _twm_cuda(x, wp, wn, thr, flip, *, mode):
    m, kw = x.shape
    n = wp.shape[1]
    _check(x, "x", torch.int32, (m, kw))
    _check(wp, "wp", torch.int32, (kw, n))
    _check(wn, "wn", torch.int32, (kw, n))
    _grid_rows(m)
    sa = mode == "sa"
    t, f = _sa_params(thr, flip, n) if sa else (None, None)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _run(_lib().twm_matmul_launch, POPCOUNT_KERNEL, x.device, x.data_ptr(),
         wp.data_ptr(), wn.data_ptr(), t, f, out.data_ptr(), m, kw, n,
         int(sa))
    return out


def _mxu_cuda(x, wt, thr, flip):
    m, kp = x.shape
    n = wt.shape[0]
    if kp % MXU_K:
        raise ValueError(f"K={kp} must be zero-padded to a multiple of "
                         f"{MXU_K}")
    _check(x, "x", torch.int8, (m, kp))
    _check(wt, "wt", torch.int8, (n, kp))
    for name, t in (("x", x), ("wt", wt)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte chunks and "
                             "needs a 16-byte aligned base")
    _grid_rows(m)
    t, f = _sa_params(thr, flip, n)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _run(_lib().twm_matmul_mxu_launch, MXU_KERNEL, x.device, x.data_ptr(),
         wt.data_ptr(), t, f, out.data_ptr(), m, kp, n)
    return out


# ---------------------------------------------------------------------------
# Entry points: CPU tensors take the plain version, CUDA tensors the kernel
# ---------------------------------------------------------------------------

def twm_matmul(x, wp, wn, thr=None, flip=None, *, mode: str = "sa"
               ) -> torch.Tensor:
    """B.7, ONE launch: (M, N) int32 packed popcount GEMM of ``x`` (M, Kw)
    against the planes ``wp``/``wn`` (Kw, N); ``raw`` or ``sa``."""
    if mode not in ("raw", "sa"):
        raise ValueError(f"mode {mode!r}")
    if x.device.type == "cpu":
        dispatch.record(POPCOUNT_KERNEL)
        return twm_matmul_plain(x, wp, wn, thr, flip, mode=mode)
    out = _twm_cuda(x, wp, wn, thr, flip, mode=mode)
    dispatch.record(POPCOUNT_KERNEL)
    return out


def twm_matmul_mxu(x, wt, thr, flip) -> torch.Tensor:
    """B.8, ONE launch: (M, N) int32 {0,1}, the SA of ``x`` (M, Kp) int8
    times the transposed weights ``wt`` (N, Kp) int8."""
    if x.device.type == "cpu":
        dispatch.record(MXU_KERNEL)
        return twm_matmul_mxu_plain(x, wt, thr, flip)
    out = _mxu_cuda(x, wt, thr, flip)
    dispatch.record(MXU_KERNEL)
    return out
