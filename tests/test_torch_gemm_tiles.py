"""Port, GEMM tiles: the host functions that pick B.7's and B.8's tile from
the shape (``twm_matmul._popcount_tile``, ``twm_matmul._mxu_tile``) pick
the intended tile on each side of the thresholds and keep the grid inside
CUDA's limits, and the dense entry points (``ops.twm_linear`` raw and
``sa``, ``ops.twm_linear_mxu``) on CPU tensors stay bit-equal to the
reference's ``repro.kernels.ops`` (Pallas in interpret mode) at the
threshold-straddling row counts.  The tiles themselves run only on the
card, where ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold each
against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import twm_matmul as tm

MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


def _covers(tile, m, n):
    """The grid covers every output once (GEMV and 64 x 64 tiles: one CTA
    per block; wgmma: persistent CTAs over the tiles)."""
    gx, gy = tile.grid
    assert 1 <= gx <= MAX_GRID_X and 1 <= gy <= MAX_GRID_Y
    if tile.kind.startswith("wgmma"):
        tiles = -(-m // tile.rows) * -(-n // tile.cols)
        assert gy == 1 and gx == min(tiles, tm.H100_SMS)
    else:
        assert (gx - 1) * tile.cols < n <= gx * tile.cols
        assert (gy - 1) * tile.rows < m <= gy * tile.rows


# (M, K, N), tile, rows per CTA: the library's launch shapes (the bench
# GEMMs, fc1's bit planes, fc2) and both sides of each threshold
POPCOUNT = [((1, 1024, 512), "gemv", 1), ((8, 352, 512), "gemv", 8),
            ((1, 512, 12), "gemv", 1), ((2, 32, 65), "gemv", 2),
            ((16, 513, 512), "gemv", 16), ((17, 1024, 12), "gemv", 16),
            ((64, 2100, 130), "gemv", 16), ((65, 100, 4096), "gemv", 16),
            ((256, 1024, 512), "gemv", 16), ((1088, 1024, 512), "gemv", 16),
            ((2048, 100, 512), "gemv", 16), ((2049, 513, 512), "tile64", 64),
            ((1024, 1024, 4096), "tile64", 64),
            ((8192, 1024, 4096), "tile64", 64), ((8192, 32, 512), "tile64",
                                                  64)]


@pytest.mark.parametrize("shape,kind,rows", POPCOUNT, ids=str)
def test_popcount_tile_choice(shape, kind, rows):
    m, k, n = shape
    kw = -(-k // 32)
    tile = tm._popcount_tile(m, kw, n)
    assert (tile.kind, tile.rows) == (kind, rows)
    if kind == "gemv":
        # one thread per (column, k-slice) of a 256-thread CTA, lanes on
        # neighbouring columns: a warp's worth of columns unless n is less
        assert tile.cols * tile.split == tm.GEMV_THREADS
        assert tile.cols == (32 if n >= 32 else max(8, 1 << (n - 1)
                                                     .bit_length()))
    _covers(tile, m, n)


# (M, K, N), tile, CTAs
MXU = [((1, 1024, 512), "gemv", 128), ((7, 100, 12), "gemv", 12),
       ((12, 1024, 512), "gemv", 128), ((13, 513, 4096), "wgmma64x64", 64),
       ((16, 513, 130), "wgmma64x64", 3), ((17, 1024, 12), "wgmma64x64", 1),
       ((64, 2100, 130), "wgmma64x64", 3), ((65, 100, 4096), "wgmma64x64",
                                            128),
       ((256, 1024, 512), "wgmma64x64", 32),
       ((2048, 1024, 512), "wgmma64x64", 132),
       ((384, 2100, 4096), "wgmma64x64", 132),
       ((385, 100, 4096), "wgmma128x256", 64),
       ((1024, 1024, 4096), "wgmma128x256", 128),
       ((8192, 32, 512), "wgmma128x256", 128),
       ((8192, 1024, 4096), "wgmma128x256", 132),
       ((65536, 1024, 4096), "wgmma128x256", 132)]


@pytest.mark.parametrize("shape,kind,ctas", MXU, ids=str)
def test_mxu_tile_choice(shape, kind, ctas):
    m, k, n = shape
    kp = -(-k // tm.MXU_K) * tm.MXU_K
    tile = tm._mxu_tile(m, n, kp)
    assert tile.kind == kind
    assert tile.grid[0] * tile.grid[1] == ctas
    if kind == "gemv":
        # warps split a column's K; the CTA's eight warps cover its columns
        assert tile.split in (1, 2, 4, 8)
        assert tile.cols * tile.split == tm.GEMV_WARPS
        assert tile.rows >= m
    _covers(tile, m, n)


def test_tile_thresholds():
    """M = 12 is the last GEMV row count of B.8 (the card's crossover),
    13 its first wgmma one; B.8 takes 128 x 256 tiles from 64 of them on;
    16 is B.7's last single row block, 17 takes two; B.7 keeps the GEMV
    tile until its 64 x 64 tiles fill two waves of the SMs."""
    assert tm._mxu_tile(12, 512, 1024).kind == "gemv"
    assert tm._mxu_tile(13, 512, 1024).kind.startswith("wgmma")
    # 3 x 16 = 48 tiles of 128 x 256 take the K-split tile, 4 x 16 the wide
    assert tm.MXU_WIDE_MIN_TILES == 64
    assert tm._mxu_tile(384, 4096, 1024).kind == "wgmma64x64"
    assert tm._mxu_tile(385, 4096, 1024).kind == "wgmma128x256"
    assert tm._popcount_tile(16, 32, 512).grid == (16, 1)
    # fc2: one CTA of 16 columns x 16 k-slices, one word per thread
    assert tm._popcount_tile(1, 16, 12)[2:] == (1, 16, 16, (1, 1))
    assert tm._popcount_tile(17, 32, 512).grid == (16, 2)
    # 132 SMs: 32 x 8 = 256 tiles of 64 x 64 fill less than two waves,
    # 33 x 8 = 264 fill two
    assert tm._popcount_tile(2048, 32, 512).kind == "gemv"
    assert tm._popcount_tile(2049, 32, 512).kind == "tile64"
    # a card with fewer SMs fills sooner, and a persistent grid never
    # launches more CTAs than it has SMs
    assert tm._popcount_tile(2048, 32, 512, sms=114).kind == "tile64"
    assert tm._mxu_tile(8192, 4096, 1024, sms=114).grid == (114, 1)


def test_tile64_grid_limit():
    """The 64 x 64 tile is not persistent: past 65,535 row tiles it
    raises rather than launch a grid CUDA refuses."""
    tile = tm._popcount_tile(MAX_GRID_Y * 64, 32, 4096)
    assert tile.grid[1] == MAX_GRID_Y
    with pytest.raises(ValueError, match="exceed the kernel grid"):
        tm._popcount_tile(MAX_GRID_Y * 64 + 1, 32, 4096)


def _dense(m, k, n, seed):
    rng = np.random.default_rng(seed)
    thr = np.round(rng.normal(0, 3, (n,))).astype(np.float32)
    thr[:2] = [np.inf, -np.inf]
    return (rng.integers(0, 2, (m, k)).astype(np.uint32),
            rng.integers(-1, 2, (k, n)).astype(np.int32), thr,
            rng.integers(0, 2, (n,)).astype(bool))


STRADDLE = [(12, 1024, 65), (13, 100, 12), (16, 513, 130), (17, 100, 12),
            (64, 1024, 65), (65, 513, 130)]


@pytest.mark.parametrize("m,k,n", STRADDLE, ids=str)
@pytest.mark.parametrize("entry", ["raw", "sa", "mxu"])
def test_dense_entry_points_match_reference_at_thresholds(m, k, n, entry):
    x, w, thr, flip = _dense(m, k, n, m * 31 + k)
    if entry == "mxu":
        args, kw, name = (x, w, thr, flip), {}, tm.MXU_KERNEL
        ref_fn, port_fn = ref_ops.twm_linear_mxu, port_ops.twm_linear_mxu
    else:
        args = (x, w) if entry == "raw" else (x, w, thr, flip)
        kw, name = dict(mode=entry), tm.POPCOUNT_KERNEL
        ref_fn, port_fn = ref_ops.twm_linear, port_ops.twm_linear
    want = np.asarray(ref_fn(*(jnp.asarray(a) for a in args), **kw))
    with dispatch.counting() as launched:
        got = port_fn(*(torch.as_tensor(a) for a in args), **kw)
    assert launched() == {name: 1}
    assert got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
