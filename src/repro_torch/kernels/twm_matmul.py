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
  fallback.  Each kernel has two tiles, and the pure host functions
  :func:`_popcount_tile` and :func:`_mxu_tile` pick one from the shape
  (a GEMV-shaped tile at small M; B.7's 64 x 64 tile, or B.8's
  persistent ``wgmma`` kernel fed by a TMA ring, at large M), so every
  call is still one launch;
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
from typing import NamedTuple

import torch

from repro_torch.core.quant import unpack_bits
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.conv_kernels import _run
from repro_torch.kernels.hop_megakernel import (
    H100_SMS,
    _check,
    _contract,
    _sa,
    _sms,
)

SOURCE = "twm_matmul"
POPCOUNT_KERNEL = "twm_matmul"
MXU_KERNEL = "twm_matmul_mxu"
#: K granularity of the int8 MMA (k32 of wgmma and of the GEMV's chunks)
MXU_K = 32
#: rows a GEMV-shaped CTA takes at most, and its threads and warps
GEMV_ROWS = 16
GEMV_THREADS = 256
GEMV_WARPS = GEMV_THREADS // 32
#: B.8 takes the GEMV-shaped tile up to this many rows, ``wgmma`` above.
#: ``chip_smoke.py``'s tile sweep on an NVIDIA H100 80GB HBM3 at 700 W, at
#: (M, 1024, 512): GEMV 0.0031 / wgmma 0.0036 ms at M = 8, 0.0036 / 0.0036
#: at 12, 0.0038 / 0.0036 at 16, 0.0042 / 0.0036 at 17
MXU_GEMV_MAX_M = 12
#: B.7's large-m tile is POPCOUNT_TILE x POPCOUNT_TILE outputs
POPCOUNT_TILE = 64
#: B.7 takes the 64 x 64 tile once its tiles fill this many waves of the
#: SMs, the GEMV-shaped one below.  ``chip_smoke.py``'s tile sweep on an
#: NVIDIA H100 80GB HBM3 at 700 W (132 SMs), ``sa``, GEMV / 64 x 64 ms at
#: 128 tiles (1024, 1024, 512): 0.0133 / 0.0147; 136 (1088, 1024, 512):
#: 0.0144 / 0.0228 (a second, nearly empty wave); 256 (2048, 1024, 512):
#: 0.0234 / 0.0230; 512 (512, 1024, 4096): 0.0436 / 0.0404; 1,024
#: (1024, 1024, 4096): 0.0835 / 0.0746
POPCOUNT_TILE64_MIN_WAVES = 2
_MAX_GRID_Y = 65535


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
        lib.twm_matmul_launch.argtypes = [P] * 6 + [I] * 9 + [P]
        lib.twm_matmul_mxu_launch.argtypes = [P] * 5 + [I] * 8 + [P]
        for fn in (lib.twm_matmul_launch, lib.twm_matmul_mxu_launch):
            fn.restype = I
        lib._twm_ready = True
    return lib


class Tile(NamedTuple):
    """One launch's tile: ``kind`` names the kernel, ``code`` is the
    launch function's tile argument, ``rows`` x ``cols`` the outputs a
    CTA (or a persistent CTA's tile) computes, ``split`` the thread
    groups (B.7) or warps (B.8) that split one column's K, ``grid`` the
    CTAs launched."""
    kind: str
    code: int
    rows: int
    cols: int
    split: int
    grid: tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows_per_cta(m: int) -> int:
    """Rows a GEMV-shaped CTA takes: ``m`` rounded up to a power of two,
    at most ``GEMV_ROWS``."""
    return min(GEMV_ROWS, 1 << max(0, m - 1).bit_length())


def _check_grid_y(grid_y: int, rows: int) -> None:
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"{grid_y * rows} rows exceed the kernel grid "
                         f"({_MAX_GRID_Y} row blocks of {rows})")


def _popcount_tile(m: int, kw: int, n: int, sms: int = H100_SMS) -> Tile:
    """B.7's tile for an (m, kw) x (kw, n) launch on ``sms`` SMs.

    The 64 x 64 tile keeps every SM at its popcount rate once its tiles
    fill ``POPCOUNT_TILE64_MIN_WAVES`` waves of the SMs; below that (and
    at m <= 16 always) the GEMV-shaped tile spreads the columns, 32 per
    CTA (fewer when n is under a warp), and up to 16 rows over more CTAs;
    the CTA's other 256 / cols threads split each column's words
    (``split``): at these sizes more warps beat longer loops per
    thread."""
    if m > GEMV_ROWS and _cdiv(m, POPCOUNT_TILE) * _cdiv(n, POPCOUNT_TILE) \
            >= POPCOUNT_TILE64_MIN_WAVES * sms:
        grid = (_cdiv(n, POPCOUNT_TILE), _cdiv(m, POPCOUNT_TILE))
        _check_grid_y(grid[1], POPCOUNT_TILE)
        return Tile("tile64", 1, POPCOUNT_TILE, POPCOUNT_TILE, 1, grid)
    rows = _rows_per_cta(m)
    cb = 32 if n >= 32 else max(8, 1 << (n - 1).bit_length())
    grid = (_cdiv(n, cb), _cdiv(m, rows))
    _check_grid_y(grid[1], rows)
    return Tile("gemv", 0, rows, cb, GEMV_THREADS // cb, grid)


#: (code, rows, cols, consumers splitting K) of the two wgmma tiles:
#: 128 x 256, and 64 x 64 with the K split between the consumers
_WGMMA_TILES = ((1, 128, 256, 1), (2, 64, 64, 2))
#: B.8 takes the 128 x 256 wgmma tile once there are at least this many
#: of them, else the 64 x 64 K-split one.  ``chip_smoke.py``'s tile sweep
#: on an NVIDIA H100 80GB HBM3 at 700 W, 128 x 256 / 64 x 64 ms at 4
#: tiles of 128 x 256 (256, 1024, 512): 0.0096 / 0.0041; 16 (1024, 1024,
#: 512): 0.0097 / 0.0042; 32 (256, 1024, 4096): 0.0101 / 0.0070 and
#: (2048, 1024, 512): 0.0100 / 0.0068; 64 (512, 1024, 4096): 0.0101 /
#: 0.0116; 128 (1024, 1024, 4096): 0.0122 / 0.0210; 1,024 (8192, 1024,
#: 4096): 0.0795 / 0.1489
MXU_WIDE_MIN_TILES = 64


def _mxu_tile(m: int, n: int, kp: int, sms: int = H100_SMS) -> Tile:
    """B.8's tile for an (m, kp) x (n, kp) launch on ``sms`` SMs.

    m <= ``MXU_GEMV_MAX_M``: the GEMV-shaped tile, one warp per column's
    weight row and ``split`` warps splitting its K, doubled while the K
    has work for them and the grid stays within one wave of CTAs.
    Larger m: the persistent ``wgmma`` kernel, on 128 x 256 tiles once
    there are ``MXU_WIDE_MIN_TILES`` of them, else on 64 x 64 tiles with
    the K split between the two consumer warpgroups."""
    if m <= MXU_GEMV_MAX_M:
        rows, chunks, wpc = _rows_per_cta(m), kp // 16, 1
        while wpc < GEMV_WARPS and chunks >= 2 * wpc and (
                chunks > 32 * wpc
                or _cdiv(n, GEMV_WARPS // (2 * wpc)) <= sms):
            wpc *= 2
        cpc = GEMV_WARPS // wpc
        grid = (_cdiv(n, cpc), _cdiv(m, rows))
        _check_grid_y(grid[1], rows)
        return Tile("gemv", 0, rows, cpc, wpc, grid)
    wide, narrow = _WGMMA_TILES
    code, bm, bn, split = (
        wide if _cdiv(m, wide[1]) * _cdiv(n, wide[2]) >= MXU_WIDE_MIN_TILES
        else narrow)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    return Tile(f"wgmma{bm}x{bn}", code, bm, bn, split, (min(tiles, sms), 1))


def _sa_params(thr, flip, n: int):
    return (_check(thr, "thr", torch.float32, (n,)),
            _check(flip, "flip", torch.int32, (n,)))


def _twm_cuda(x, wp, wn, thr, flip, *, mode, tile: Tile | None = None):
    """One B.7 launch; ``tile`` overrides :func:`_popcount_tile`'s choice
    (``chip_smoke.py`` times both tiles on each side of the threshold)."""
    m, kw = x.shape
    n = wp.shape[1]
    _check(x, "x", torch.int32, (m, kw))
    _check(wp, "wp", torch.int32, (kw, n))
    _check(wn, "wn", torch.int32, (kw, n))
    tile = tile or _popcount_tile(m, kw, n, _sms(x.device))
    sa = mode == "sa"
    t, f = _sa_params(thr, flip, n) if sa else (None, None)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _run(_lib().twm_matmul_launch, POPCOUNT_KERNEL, x.device, x.data_ptr(),
         wp.data_ptr(), wn.data_ptr(), t, f, out.data_ptr(), m, kw, n,
         int(sa), tile.code, tile.rows, tile.cols, *tile.grid)
    return out


def _mxu_cuda(x, wt, thr, flip, *, tile: Tile | None = None):
    """One B.8 launch; ``tile`` overrides :func:`_mxu_tile`'s choice."""
    m, kp = x.shape
    n = wt.shape[0]
    if kp % MXU_K:
        raise ValueError(f"K={kp} must be zero-padded to a multiple of "
                         f"{MXU_K}")
    _check(x, "x", torch.int8, (m, kp))
    _check(wt, "wt", torch.int8, (n, kp))
    for name, t in (("x", x), ("wt", wt)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels load 16-byte chunks and "
                             "need a 16-byte aligned base")
    tile = tile or _mxu_tile(m, n, kp, _sms(x.device))
    t, f = _sa_params(thr, flip, n)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _run(_lib().twm_matmul_mxu_launch, MXU_KERNEL, x.device, x.data_ptr(),
         wt.data_ptr(), t, f, out.data_ptr(), m, kp, n, tile.code,
         tile.rows, tile.split, *tile.grid)
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
