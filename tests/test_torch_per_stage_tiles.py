"""Port, conv kernel host functions: B.4's and B.5's launch shapes
(``conv_kernels.conv_step_tiles``, ``step_item``, ``tail_tiles``), their
weight layouts (``prepare_step_weights``, ``prepare_tail_weights``), the
memo that lays out raw weights once per tensor, and the per-stage
scheduler laying its weights out once per model; and B.6, which is B.4's
kernel over blocks of one stream's pooled positions, with its launch shape
(``conv_block_tiles``).

The CUDA kernels run only on the card, where ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold them against their plain versions.  Here a
plain-torch emulation of each kernel -- its CTAs and MMA items, the u8
rows it stages in shared memory (garbage wherever it writes nothing), the
A rows and B fragments it reads, its SA, OR-pool and tenant passes, and
the lane exchange of B.4's epilogue -- must give ``conv_step_plain`` /
``conv1d_plain`` / ``classifier_tail_plain`` bit for bit on seeded
inputs, write every output exactly once, and read only bytes the kernel
staged.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cnn_spec import Conv1DSpec, GAPSpec
from repro_torch.kernels import conv_kernels as bk
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.hop_megakernel import _cdiv
from repro_torch.models import kws
from repro_torch.stream import StreamScheduler
from repro_torch.stream.state import plan_stream


def _b_tile(frag_bytes, jt, kk, ks):
    """The (8, 32) B block the lanes' fragment loads give for n-tile
    ``jt`` and k-step ``kk`` of a run of fragment-order bytes: lane
    4 g + t holds column g at depths 4 t + {0..3} (bytes 0-3) and
    16 + 4 t + {0..3} (bytes 4-7)."""
    base = (jt * ks + kk) * 256
    frag = frag_bytes[base:base + 256].reshape(32, 8)
    out = torch.empty((8, 32), dtype=torch.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        out[g, 4 * t:4 * t + 4] = frag[lane, :4]
        out[g, 16 + 4 * t:16 + 4 * t + 4] = frag[lane, 4:]
    return out


# ---------------------------------------------------------------------------
# B.4: an emulation of bnn_conv1d_step_kernel
# ---------------------------------------------------------------------------

def _bits(words):
    """int32 words (..., n) -> (..., 32 n) int64 lanes, bit 0 first."""
    w = words.long() & 0xFFFFFFFF
    return ((w[..., None] >> torch.arange(32)) & 1).flatten(-2)


def _emulate_items(out, writes, win, wsm, thr, flip, *, rows, runs, orow0,
                   j0, ntc, cout, rstep, npool, sa, tile):
    """One CTA's MMA items over its staged words ``win`` and weights
    ``wsm`` (its n-tiles' fragments): ``runs(r)`` gives, for output rows
    ``r``, the word where each row's depth run starts and the staged words
    ``[lo, hi)`` it may read; 1-bit MMAs as popcounts of ANDs, SA and
    OR-pool per phase, and the epilogue's lane exchange into rows ``orow0
    + r`` of ``out``."""
    lanes = torch.arange(32)
    g_, t_ = lanes // 4, lanes % 4
    odd = t_ & 1
    ht = torch.arange(8)            # word 4 h + t of a k-step
    ks = wsm.shape[1]
    mts = _cdiv(rows, 16)
    mgs, ngs = _cdiv(mts, tile.mc), _cdiv(ntc, tile.ng)
    for it in range(mgs * ngs):
        jg, mg = it % ngs, it // ngs
        spans = [runs(torch.clamp((mg * tile.mc + mi) * 16 + torch.arange(16),
                                  max=rows - 1)) for mi in range(tile.mc)]
        vals = {}
        for q in range(npool):
            for ni in range(tile.ng):
                jt = min(jg * tile.ng + ni, ntc - 1)
                for mi in range(tile.mc):
                    base, lo, hi = spans[mi]
                    acc = torch.zeros((16, 8), dtype=torch.int64)
                    for kk in range(ks):
                        addr = (base + q * rstep + 8 * kk)[:, None] + ht
                        # every word read is the row's own
                        assert ((addr >= lo[:, None])
                                & (addr < hi[:, None])).all()
                        a = _bits(win[addr])                    # (16, 256)
                        frag = wsm[jt, kk]                      # (32, 4)
                        bp = frag[:, :2].reshape(8, 4, 2)
                        bn = frag[:, 2:].reshape(8, 4, 2)
                        # word 4 h + t of column g
                        bp = _bits(bp.permute(0, 2, 1).reshape(8, 8))
                        bn = _bits(bn.permute(0, 2, 1).reshape(8, 8))
                        acc += a @ bp.T - a @ bn.T
                    col = torch.clamp((j0 + jt) * 8 + torch.arange(8),
                                      max=cout - 1)
                    if sa:
                        y = (acc.float() >= thr[col]) != (flip[col] != 0)
                        vals[ni, mi] = vals.get((ni, mi), 0) | y.long()
                    else:
                        vals[ni, mi] = acc
        for ni in range(tile.ng):
            if jg * tile.ng + ni >= ntc:
                break
            for mi in range(tile.mc):
                v = vals[ni, mi]
                # lane (g, t): c0 c1 of row g, c2 c3 of row g + 8
                vl = torch.stack([v[g_, 2 * t_], v[g_, 2 * t_ + 1],
                                  v[g_ + 8, 2 * t_], v[g_ + 8, 2 * t_ + 1]],
                                 1)
                send = torch.where(odd[:, None] == 1, vl[:, :2], vl[:, 2:])
                recv = send[lanes ^ 1]
                o = torch.where(odd[:, None] == 1,
                                torch.cat([recv, vl[:, 2:]], 1),
                                torch.cat([vl[:, :2], recv], 1))
                row = (mg * tile.mc + mi) * 16 + g_ + 8 * odd
                col = (j0 + jg * tile.ng + ni) * 8 + 4 * (t_ >> 1)
                for lane in range(32):
                    rr, cc = int(row[lane]), int(col[lane])
                    if rr >= rows or cc >= cout:
                        continue
                    for e in range(4):
                        if cc + e < cout:
                            out[orow0 + rr, cc + e] = o[lane, e]
                            writes[orow0 + rr, cc + e] += 1


def _emulate_step(x, wf, thr, flip, model_idx, *, cout, k, stride, l_out,
                  pool, mode, tile, rng):
    """The kernel's output, CTA by CTA and item by item: its staged words,
    its A and B fragment words, 1-bit MMAs as popcounts of ANDs, SA and
    OR-pool per phase, and its epilogue's lane exchange."""
    b, l_in, cw = x.shape
    nt = wf.shape[-4]
    sa = mode == "sa"
    npool = pool if sa else 1
    n_out = l_out // pool if sa else l_out
    rows_in = bk.step_rows(n_out, npool, stride, k)
    win_words = bk.step_win_words(rows_in, cw)
    assert rows_in <= l_in
    wf_m = wf if wf.dim() == 5 else wf[None]
    out = torch.zeros((b * n_out, cout), dtype=torch.int64)
    writes = torch.zeros((b * n_out, cout), dtype=torch.int64)

    def runs(r):
        s, n = r // n_out, r % n_out
        return (s * win_words + n * npool * stride * cw, s * win_words,
                (s + 1) * win_words)
    for bx in range(_cdiv(b, tile.slots)):
        for by in range(_cdiv(nt, tile.ntb)):
            b0, j0 = bx * tile.slots, by * tile.ntb
            ns, ntc = min(tile.slots, b - b0), min(tile.ntb, nt - j0)
            m = int(model_idx[b0]) if model_idx is not None else 0
            assert bk.step_smem(ns, tile.ntb, cw, k, rows_in) <= tile.smem
            # staged words: garbage wherever the copy writes nothing
            win = torch.as_tensor(rng.integers(-2**31, 2**31, tile.slots
                                               * win_words))
            for s in range(ns):
                win[s * win_words:s * win_words + rows_in * cw] = \
                    x[b0 + s, :rows_in].reshape(-1).long()
            _emulate_items(out, writes, win, wf_m[m][j0:j0 + ntc], thr, flip,
                           rows=ns * n_out, runs=runs, orow0=b0 * n_out,
                           j0=j0, ntc=ntc, cout=cout,
                           rstep=stride * cw, npool=npool, sa=sa, tile=tile)
    assert (writes == 1).all()
    return out.reshape(b, n_out, cout).to(torch.int32)


def _step_case(rng, b, cin, cout, k, stride, l_out, pool, km):
    l_in = (l_out - 1) * stride + k + int(rng.integers(0, 3))
    x = ops.pack_activations(torch.as_tensor(
        rng.integers(0, 2, (b, l_in, cin)).astype(np.int32))).contiguous()
    lead = (km,) if km > 1 else ()
    w = torch.as_tensor(rng.integers(-1, 2, lead + (k, cin, cout)).astype(
        np.int32))
    wp, wn = ops.pack_weight_planes(w)
    thr = torch.as_tensor(np.round(rng.normal(0, 3, cout)).astype(
        np.float32))
    thr[:2] = torch.tensor([np.inf, -np.inf])
    flip = torch.as_tensor((rng.random(cout) < 0.3).astype(np.int32))
    mi = (torch.as_tensor(rng.integers(0, km, b).astype(np.int32))
          if km > 1 else None)
    return x, wp.contiguous(), wn.contiguous(), thr, flip, mi


# (B, cin, cout, k, stride, l_out, mode, pool, tenant models, forced tile
# (slots, n-tiles per CTA, item n-tiles, item m-tiles) or None): ragged
# cout (not a multiple of 8, nor of 4), positions off the 16-row tile,
# stride 2, pools 2 and 3, a K=2 pool, slot blocks past the batch's end,
# one word a row
STEP_CASES = [
    (5, 40, 20, 3, 1, 19, "raw", 1, 1, None),
    (3, 40, 22, 3, 2, 7, "raw", 1, 1, None),
    (7, 64, 16, 5, 1, 3, "raw", 1, 1, (4, 1, 1, 2)),
    (9, 33, 24, 3, 1, 2, "raw", 1, 1, (8, 2, 2, 1)),
    (6, 40, 13, 3, 1, 17, "sa", 2, 1, None),
    (4, 40, 20, 3, 1, 18, "sa", 3, 1, (2, 2, 2, 2)),
    (5, 70, 12, 3, 2, 9, "sa", 1, 1, (2, 1, 1, 1)),
    (6, 40, 20, 3, 1, 11, "raw", 1, 2, None),
    (3, 96, 40, 3, 1, 5, "raw", 1, 1, (2, 4, 4, 1)),
    (4, 24, 16, 5, 1, 9, "sa", 2, 1, None),
]


@pytest.mark.parametrize(
    "b,cin,cout,k,stride,l_out,mode,pool,km,forced", STEP_CASES, ids=str)
def test_step_emulation_matches_plain(b, cin, cout, k, stride, l_out, mode,
                                      pool, km, forced):
    rng = np.random.default_rng(b * 31 + cout + l_out)
    x, wp, wn, thr, flip, mi = _step_case(rng, b, cin, cout, k, stride,
                                          l_out, pool, km)
    sa = mode == "sa"
    n_out = l_out // pool if sa else l_out
    wf = bk.prepare_step_weights(wp, wn)
    cw = x.shape[-1]
    assert wf.shape == (*wp.shape[:-3], _cdiv(cout, 8), _cdiv(k * cw, 8),
                        32, 4)
    if forced is None:
        tile = bk.conv_step_tiles(b, cw, k, stride, cout, n_out,
                                  pool if sa else 1, mi is not None)
    else:
        slots, ntb, ng, mc = forced
        smem = bk.step_smem(min(slots, b), ntb, cw, k, bk.step_rows(
            n_out, pool if sa else 1, stride, k))
        tile = bk.StepTile(slots, ntb, ng, mc, smem)
    kw = dict(k=k, stride=stride, l_out=l_out, pool=pool, mode=mode)
    want = bk.conv_step_plain(x, wp, wn, thr if sa else None,
                              flip if sa else None, mi, **kw)
    got = _emulate_step(x, wf, thr if sa else None, flip if sa else None,
                        mi, cout=cout, tile=tile, rng=rng, **kw)
    assert torch.equal(got, want)


def test_step_layout_keeps_the_pool_axis_and_pads_with_zeros():
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.integers(-1, 2, (2, 3, 40, 20)).astype(np.int32))
    wp, wn = ops.pack_weight_planes(w)
    wf = bk.prepare_step_weights(wp, wn)
    # 20 columns -> 3 n-tiles; 3 taps x 2 words -> one k-step of 8 words
    assert wf.shape == (2, 3, 1, 32, 4) and wf.dtype == torch.int32
    for m in range(2):
        one = bk.prepare_step_weights(*ops.pack_weight_planes(w[m]))
        assert torch.equal(one, wf[m])
    # lane 4 g + t, word 2 p + h: plane p's depth word 4 h + t of column g
    for p, plane in enumerate((wp[0], wn[0])):
        dense = torch.zeros((8, 24), dtype=torch.int64)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for h in range(2):
                dense[4 * h + t, g::8] = wf[0, :, 0, lane, 2 * p + h].long()
        want = torch.zeros((8, 24), dtype=torch.int64)
        want[:6, :20] = plane.reshape(6, 20).long()
        assert torch.equal(dense, want)


def test_conv_weights_lay_out_only_for_the_conv_step():
    w = torch.ones((3, 40, 8), dtype=torch.int32)
    assert ops.conv_weights(w).wf.shape == (1, 1, 32, 4)
    assert ops.conv_weights(w, layout=False).wf is None


# ---------------------------------------------------------------------------
# B.6: an emulation of the kernel's one-stream mode, and its launch shape
# ---------------------------------------------------------------------------

def _emulate_conv1d(x, wf, thr, flip, *, cout, k, stride, pad, l_out, pool,
                    mode, tile, rng):
    """B.6's output, CTA by CTA: each block of pooled positions stages its
    input rows from the 16-byte boundary at or before its first (``lead``
    words early), zero words outside the input (the conv's padding) and
    garbage past the copy, into the window words the CTA's shared memory
    has; then B.4's items over them, its rows the block's positions."""
    l_in, cw = x.shape
    nt, ks = wf.shape[:2]
    sa = mode == "sa"
    npool = pool if sa else 1
    n_pos = l_out // npool
    flat = x.reshape(-1).long()
    total, rstep = flat.numel(), stride * cw
    avail = (tile.smem - tile.ntb * ks * 512) // 4   # the window's words
    out = torch.zeros((n_pos, cout), dtype=torch.int64)
    writes = torch.zeros((n_pos, cout), dtype=torch.int64)
    for bx in range(_cdiv(n_pos, tile.pb)):
        n0 = bx * tile.pb
        nper = min(tile.pb, n_pos - n0)
        first = (n0 * npool * stride - pad) * cw
        lead = first % 4
        g0 = first - lead
        # whole 16-byte chunks from g0 over the block's rows
        n_copy = _cdiv(lead + bk.step_rows(nper, npool, stride, k) * cw,
                       4) * 4
        assert g0 % 4 == 0 and n_copy <= avail

        def runs(r, lead=lead):
            return (lead + r * npool * rstep, torch.full_like(r, lead),
                    torch.full_like(r, avail))
        for by in range(_cdiv(nt, tile.ntb)):
            j0 = by * tile.ntb
            ntc = min(tile.ntb, nt - j0)
            win = torch.as_tensor(rng.integers(-2**31, 2**31, avail))
            g = g0 + torch.arange(n_copy)
            inside = (g >= 0) & (g < total)
            win[:n_copy] = torch.where(inside, flat[g.clamp(0, total - 1)], 0)
            _emulate_items(out, writes, win, wf[j0:j0 + ntc], thr, flip,
                           rows=nper, runs=runs, orow0=n0, j0=j0, ntc=ntc,
                           cout=cout, rstep=rstep, npool=npool, sa=sa,
                           tile=tile)
    assert (writes == 1).all()
    return out.to(torch.int32)


# (L, cin, cout, k, stride, pad, pool, mode, forced tile (pooled positions,
# n-tiles per CTA, item n-tiles, item m-tiles) or None): the utterance's
# b1-b3 at the smoke width (b3's 25 positions drop one to the pool) and at
# full width (b1's blocks start 2 words past a 16-byte boundary), then raw
# at k=7 stride 2 pad 3, an even k with pad 0 and cout off 8 and off 4 at
# pool 4, cout off 8 alone, three words a row at pool 3, and forced items
CONV_CASES = [
    (100, 16, 32, 3, 1, 1, 2, "sa", None),
    (50, 32, 64, 5, 1, 2, 2, "sa", None),
    (25, 64, 88, 3, 1, 1, 2, "sa", None),
    (2000, 64, 128, 3, 1, 1, 2, "sa", None),
    (1000, 128, 256, 5, 1, 2, 2, "sa", None),
    (500, 256, 352, 3, 1, 1, 2, "sa", None),
    (50, 32, 64, 5, 1, 2, 1, "raw", None),
    (300, 40, 48, 7, 2, 3, 1, "raw", None),
    (61, 100, 65, 2, 2, 0, 4, "sa", (8, 3, 2, 1)),
    (33, 8, 12, 2, 2, 0, 2, "sa", None),
    (77, 96, 13, 3, 1, 1, 3, "sa", (16, 2, 2, 1)),
    (129, 100, 65, 5, 1, 2, 1, "sa", (64, 9, 4, 1)),
    (400, 40, 48, 3, 1, 1, 2, "sa", (128, 6, 2, 2)),
    (300, 40, 20, 7, 2, 3, 1, "raw", (256, 1, 1, 4)),
]


@pytest.mark.parametrize("l,cin,cout,k,stride,pad,pool,mode,forced",
                         CONV_CASES, ids=str)
def test_conv1d_emulation_matches_plain(l, cin, cout, k, stride, pad, pool,
                                        mode, forced):
    rng = np.random.default_rng(l + cin + cout)
    x = ops.pack_activations(torch.as_tensor(
        rng.integers(0, 2, (l, cin)).astype(np.int32))).contiguous()
    w = torch.as_tensor(rng.integers(-1, 2, (k, cin, cout)).astype(np.int32))
    wp, wn = (t.contiguous() for t in ops.pack_weight_planes(w))
    thr = torch.as_tensor(np.round(rng.normal(0, 3, cout)).astype(
        np.float32))
    thr[:2] = torch.tensor([np.inf, -np.inf])
    flip = torch.as_tensor((rng.random(cout) < 0.3).astype(np.int32))
    sa = mode == "sa"
    npool = pool if sa else 1
    l_out = (l + 2 * pad - k) // stride + 1
    cw, n_pos = x.shape[1], l_out // npool
    if forced is None:
        tile = bk.conv_block_tiles(cw, k, stride, cout, n_pos, npool)
    else:
        pb, ntb, ng, mc = forced
        tile = bk.BlockTile(pb, ntb, ng, mc, bk.block_smem(
            min(pb, n_pos), ntb, cw, k, stride, npool))
    kw = dict(k=k, stride=stride, pad=pad, l_out=l_out, pool=npool,
              mode=mode)
    want = bk.conv1d_plain(x, wp, wn, thr if sa else None,
                           flip if sa else None, **kw)
    got = _emulate_conv1d(x, bk.prepare_step_weights(wp, wn),
                          thr if sa else None, flip if sa else None,
                          cout=cout, tile=tile, rng=rng, **kw)
    assert torch.equal(got, want)


# (cw, k, stride, cout, pooled positions, positions a pooled one takes):
# the utterance's b1-b3 at full width, sa pool 2 and raw, and at the
# smoke width, k=7 stride 2, and a deep window
BLOCK_SHAPES = [
    (2, 3, 1, 128, 1000, 2), (4, 5, 1, 256, 500, 2), (8, 3, 1, 352, 250, 2),
    (2, 3, 1, 128, 2000, 1), (4, 5, 1, 256, 1000, 1), (8, 3, 1, 352, 500, 1),
    (1, 3, 1, 32, 50, 2), (1, 5, 1, 64, 25, 2), (2, 3, 1, 88, 12, 2),
    (2, 7, 2, 48, 150, 1), (240, 3, 1, 64, 10, 4),
]


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_conv_block_tiles_fit_and_cover_once(shape):
    """B.6's launch shape fits a block's shared memory, its CTAs cover
    every pooled position and output column exactly once, every SM gets a
    CTA where there are enough blocks, and the shape is memoized."""
    cw, k, stride, cout, n_pos, npool = shape
    t = bk.conv_block_tiles(*shape)
    assert t.pb in bk.CONV_BLOCKS and (t.ng, t.mc) in bk.STEP_ITEMS
    assert t.smem == bk.block_smem(min(t.pb, n_pos), t.ntb, cw, k, stride,
                                   npool) <= bk.MAX_SMEM
    nt = _cdiv(cout, 8)
    seen = torch.zeros((n_pos, cout), dtype=torch.int64)
    for bx in range(_cdiv(n_pos, t.pb)):
        for by in range(_cdiv(nt, t.ntb)):
            seen[bx * t.pb:(bx + 1) * t.pb,
                 by * t.ntb * 8:(by + 1) * t.ntb * 8] += 1
    assert (seen == 1).all()
    ctas = _cdiv(n_pos, t.pb) * _cdiv(nt, t.ntb)
    assert ctas >= min(132, _cdiv(n_pos, bk.CONV_BLOCKS[0]) * nt)
    before = bk.conv_block_tiles.cache_info().hits
    assert bk.conv_block_tiles(*shape) is t
    assert bk.conv_block_tiles.cache_info().hits == before + 1


def test_conv_block_tiles_shrink_to_fit_and_refuse_past_it():
    # a deep window: the whole n-range does not fit, a block of it does
    t = bk.conv_block_tiles(240, 9, 1, 64, 40)
    assert t.smem <= bk.MAX_SMEM and t.ntb < 8
    with pytest.raises(ValueError, match="shared memory"):
        bk.conv_block_tiles(2000, 9, 4, 8, 20)


# ---------------------------------------------------------------------------
# B.4's launch shape
# ---------------------------------------------------------------------------

# (B, cw, k, stride, cout, n_out, pool, pooled) -> (slots, n-tiles a CTA,
# item n-tiles, item m-tiles): a hop's b1-b3 windows and flush windows at
# B = 256, the SA pool-2 launch, 200 and 1 slot, and a weight pool
STEP_TILES = [
    ((256, 2, 3, 1, 128, 64, 1, False), (4, 4, 2, 2)),
    ((256, 4, 5, 1, 256, 32, 1, False), (8, 4, 2, 2)),
    ((256, 8, 3, 1, 352, 16, 1, False), (2, 22, 2, 2)),
    ((256, 2, 3, 1, 128, 2, 1, False), (16, 1, 1, 1)),
    ((256, 4, 5, 1, 256, 3, 1, False), (16, 2, 1, 1)),
    ((256, 8, 3, 1, 352, 2, 1, False), (16, 3, 1, 1)),
    ((256, 2, 3, 1, 128, 32, 2, False), (4, 4, 2, 2)),
    ((200, 4, 5, 1, 256, 32, 1, False), (8, 4, 2, 2)),
    ((1, 8, 3, 1, 352, 16, 1, False), (1, 1, 1, 1)),
    ((256, 4, 5, 1, 256, 32, 1, True), (1, 32, 2, 2)),
]


@pytest.mark.parametrize("shape,want", STEP_TILES, ids=str)
def test_conv_step_tiles(shape, want):
    b, cw, k, stride, cout, n_out, pool, pooled = shape
    t = bk.conv_step_tiles(*shape)
    assert (t.slots, t.ntb, t.ng, t.mc) == want
    rows_in = bk.step_rows(n_out, pool, stride, k)
    assert t.smem == bk.step_smem(min(t.slots, b), t.ntb, cw, k, rows_in)
    assert t.smem <= bk.MAX_SMEM
    ctas = _cdiv(b, t.slots) * _cdiv(_cdiv(cout, 8), t.ntb)
    assert ctas >= min(132, b * _cdiv(cout, 8))   # every SM gets a CTA


def test_conv_step_tiles_shrink_to_fit_and_refuse_past_it():
    # a deep window: the whole n-range does not fit, a block of it does
    t = bk.conv_step_tiles(4, 64, 7, 1, 64, 40)
    assert t.smem <= bk.MAX_SMEM and t.ntb < 8
    with pytest.raises(ValueError, match="shared memory"):
        bk.conv_step_tiles(1, 256, 9, 4, 8, 20)


@pytest.mark.parametrize("rows,ntb,want", [
    (512, 2, (2, 2)), (256, 2, (2, 2)), (16, 1, (1, 1)), (64, 8, (2, 2)),
    (512, 16, (2, 2)), (32, 3, (1, 1)), (48, 4, (1, 2)), (16, 32, (4, 1)),
    (512, 1, (1, 4)), (16, 4, (1, 1))], ids=str)
def test_step_item(rows, ntb, want):
    assert bk.step_item(rows, ntb) == want


# ---------------------------------------------------------------------------
# B.5: an emulation of classifier_tail_kernel, and its launch shape
# ---------------------------------------------------------------------------

def _emulate_tail(gap, tw, thrs, flips, model_idx, *, out_raw, tile, rng):
    """The kernel's logits, cluster by cluster: each CTA rank writes its
    share of the GAP columns and of each layer's n-tiles into the rows
    every CTA of the cluster reads (one copy here)."""
    b, gap_c = gap.shape
    frag = [f if f.dim() == 5 else f[None] for f in tw.frag]
    n_out = tw.ws[-1].shape[-1]
    out = torch.zeros((b, n_out), dtype=torch.int64)
    writes = torch.zeros((b, n_out), dtype=torch.int64)
    for b0 in range(0, b, tile.slots):
        ns = min(tile.slots, b - b0)
        mdl = [int(model_idx[b0 + s]) if model_idx is not None else 0
               for s in range(ns)]
        models = list(dict.fromkeys(mdl))
        # only the slots' GAP columns are written: the rest stays garbage
        hin = torch.as_tensor(rng.integers(0, 256, (16, tile.pitch)))
        for rank in range(tile.cluster):
            lo, hi = bk.tail_share(gap_c, tile.cluster, rank)
            hin[:ns, lo:hi] = torch.clamp(gap[b0:b0 + ns, lo:hi].long(),
                                          max=255)
        hout = torch.as_tensor(rng.integers(0, 256, (16, tile.pitch)))
        for j, raw in enumerate(out_raw):
            nt, ks = frag[j].shape[1:3]
            cout = tw.ws[j].shape[-1]
            ct = tile.ring_bytes // (ks * 256)
            assert ct >= 1
            for rank in range(tile.cluster):
                lo, hi = bk.tail_share(nt, tile.cluster, rank)
                for m in models:
                    rows = [s for s in range(ns) if mdl[s] == m]
                    run = frag[j][m].reshape(-1)[lo * ks * 256:hi * ks * 256]
                    for c in range(_cdiv(hi - lo, ct)):
                        chunk = run[c * ct * ks * 256:
                                    (c + 1) * ct * ks * 256]
                        assert chunk.numel() <= tile.ring_bytes
                        for jt in range(min(ct, hi - lo - c * ct)):
                            acc = torch.zeros((16, 8), dtype=torch.int64)
                            for kk in range(ks):
                                assert kk * 32 + 32 <= tile.pitch
                                acc += hin[:, kk * 32:kk * 32 + 32] @ \
                                    _b_tile(chunk, jt, kk, ks).T
                            col0 = (lo + c * ct + jt) * 8
                            for s in rows:
                                v = acc[s].clone()
                                if not raw:
                                    th = thrs[j] if thrs[j].dim() == 1 \
                                        else thrs[j][m]
                                    fl = flips[j] if flips[j].dim() == 1 \
                                        else flips[j][m]
                                    cols = torch.clamp(col0 + torch.arange(
                                        8), max=cout - 1)
                                    v = ((v.float() >= th[cols])
                                         != (fl[cols] != 0)).long()
                                if j + 1 < len(out_raw):
                                    # all 8 columns of the n-tile, those
                                    # past cout SA'd at the last column's
                                    # parameters (they meet zero weights)
                                    hout[s, col0:col0 + 8] = v
                                    continue
                                for e in range(8):
                                    if col0 + e < cout:
                                        out[b0 + s, col0 + e] = v[e]
                                        writes[b0 + s, col0 + e] += 1
            hin, hout = hout, hin
    assert (writes == 1).all()
    return out.to(torch.int32)


def _tail_case(rng, b, dims, out_raw, km):
    lead = (km,) if km > 1 else ()
    gap = torch.as_tensor(rng.integers(0, 400, (b, dims[0])).astype(
        np.int32))
    ws, thrs, flips = [], [], []
    for j in range(len(out_raw)):
        ws.append(torch.as_tensor(rng.integers(
            -1, 2, lead + (dims[j], dims[j + 1])).astype(np.int8)))
        scale = 40 if j == 0 else 3
        thrs.append(torch.as_tensor(np.round(rng.normal(
            0, scale, lead + (dims[j + 1],))).astype(np.float32)))
        flips.append(torch.as_tensor((rng.random(
            lead + (dims[j + 1],)) < 0.3).astype(np.int32)))
    mi = (torch.as_tensor(rng.integers(0, km, b).astype(np.int32))
          if km > 1 else None)
    return gap, ws, thrs, flips, mi


# (B, widths, out_raw, tenant models, slots per cluster, CTAs per cluster;
# None for the rule's): tenants, three layers, a single raw layer
TAIL_CASES = [
    (5, (40, 24, 12), (False, True), 1, None, None),
    (19, (40, 24, 12), (False, True), 1, 4, 1),
    (9, (70, 33, 20, 12), (False, False, True), 1, 8, 4),
    (21, (40, 24, 12), (False, True), 3, 16, 2),
    (3, (352, 512, 12), (False, True), 1, 2, None),
    (17, (352, 512, 12), (False, True), 2, 16, 8),
    (6, (40, 12), (True,), 2, None, None),
]


@pytest.mark.parametrize("b,dims,out_raw,km,slots,cluster", TAIL_CASES,
                         ids=str)
def test_tail_emulation_matches_plain(b, dims, out_raw, km, slots, cluster):
    rng = np.random.default_rng(b + len(dims) + km)
    gap, ws, thrs, flips, mi = _tail_case(rng, b, dims, out_raw, km)
    tw = bk.prepare_tail_weights(ws)
    assert tw.ws[0] is ws[0]
    tile = bk.tail_tiles(b, list(zip(dims[:-1], dims[1:])), slots, cluster)
    want = bk.classifier_tail_plain(gap, ws, thrs, flips, mi,
                                    out_raw=out_raw)
    got = _emulate_tail(gap, tw, thrs, flips, mi, out_raw=out_raw,
                        tile=tile, rng=rng)
    assert torch.equal(got, want)
    # the plain version and the CPU entry point take the laid-out form too
    assert torch.equal(bk.classifier_tail_plain(gap, tw, thrs, flips, mi,
                                                out_raw=out_raw), want)


def test_tail_layout_keeps_the_pool_axis():
    rng = np.random.default_rng(5)
    ws = [torch.as_tensor(rng.integers(-1, 2, (3, 40, 20)), dtype=torch.int8)]
    tw = bk.prepare_tail_weights(ws)
    assert tw.frag[0].shape == (3, 3, 2, 32, 8)
    for m in range(3):
        assert torch.equal(bk.prepare_tail_weights([ws[0][m]]).frag[0],
                           tw.frag[0][m])


# (B, slots, CTAs per cluster; None for the rule's) -> slots, CTAs,
# n-tiles of fc1 a ring chunk holds (a CTA's whole share where it fits)
TAIL_TILES = [((256, None, None), (16, 4, 16)), ((64, None, None), (8, 8, 8)),
              ((1, None, None), (2, 8, 8)), ((4096, None, None), (16, 1, 21)),
              ((256, 4, 2), (4, 2, 32)), ((256, 16, 2), (16, 2, 29)),
              ((256, 2, 8), (2, 8, 8)), ((256, 16, 1), (16, 1, 21))]


@pytest.mark.parametrize("args,want", TAIL_TILES, ids=str)
def test_tail_tiles_kws(args, want):
    b, slots, cluster = args
    t = bk.tail_tiles(b, [(352, 512), (512, 12)], slots, cluster)
    assert (t.slots, t.cluster, t.ring_bytes // (11 * 256)) == want
    assert t.pitch == 528                   # 512 + 16: distinct banks
    assert t.sa_cols == 512 // t.cluster     # its share of fc1's columns
    assert t.ring_bytes >= 16 * 256          # fc2's deepest n-tile
    assert t.smem == (2 * t.ring_bytes + 2 * 16 * 528
                      + 8 * t.slots * t.sa_cols + 4 * 4 * 256
                      + 4 * t.slots * -(-352 // t.cluster))
    assert t.smem + bk.TAIL_STATIC_SMEM <= bk.MAX_SMEM


@pytest.mark.parametrize("b,want", [(1, (2, 8)), (8, (2, 8)), (64, (8, 8)),
                                    (65, (16, 8)), (256, (16, 4)),
                                    (528, (16, 2)), (1056, (16, 1)),
                                    (5000, (16, 1))])
def test_tail_block(b, want):
    """The largest cluster, then the fewest slots, that keep the launch
    within one CTA for every two SMs."""
    assert bk.tail_block(b, 64) == want
    slots, cluster = want
    assert -(-b // slots) * cluster <= 66 or want == (16, 1)
    # a first layer of 3 n-tiles caps the cluster at 2
    assert bk.tail_block(1, 3)[1] == 2


def test_tail_cluster_splits_cover_each_layer_once():
    for n in (1, 2, 12, 44, 64, 352):
        for parts in bk.TAIL_CLUSTERS:
            shares = [bk.tail_share(n, parts, r) for r in range(parts)]
            assert [i for lo, hi in shares for i in range(lo, hi)] == \
                list(range(n))
    # a first layer of 3 n-tiles takes a cluster of 2
    assert bk.tail_tiles(4, [(40, 24), (24, 12)]).cluster == 2


def test_tail_tiles_cap_the_ring_and_refuse_past_it():
    # fc1's share (64 n-tiles of 64 k-steps) does not fit: the ring holds
    # what does, at least one of the deepest layer's n-tiles
    t = bk.tail_tiles(4, [(2048, 512), (512, 12)], cluster=1)
    assert 64 * 256 <= t.ring_bytes < 64 * 64 * 256
    assert t.smem + bk.TAIL_STATIC_SMEM <= bk.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        bk.tail_tiles(4, [(40000, 8)])
    with pytest.raises(ValueError, match="slots"):
        bk.tail_tiles(4, [(40, 8)], slots=3)
    with pytest.raises(ValueError, match="CTAs"):
        bk.tail_tiles(4, [(40, 8)], cluster=16)


def test_tail_refuses_a_raw_hidden_layer_on_the_card():
    meta = dict(device="meta")
    gap = torch.zeros((2, 8), dtype=torch.int32, **meta)
    ws = [torch.zeros((8, 4), dtype=torch.int8, **meta),
          torch.zeros((4, 2), dtype=torch.int8, **meta)]
    with pytest.raises(ValueError, match="only the last fc layer"):
        bk.classifier_tail(gap, ws, [None, None], [None, None],
                           out_raw=(True, True))


# ---------------------------------------------------------------------------
# Layouts made once: per tensor for raw callers, per model for the scheduler
# ---------------------------------------------------------------------------

def test_memo_lays_out_once_per_tensor():
    made = []

    def make():
        made.append(1)
        return len(made)

    w = torch.zeros((4, 4), dtype=torch.int8)
    assert bk._memo_layout((w,), make) == 1
    assert bk._memo_layout((w,), make) == 1          # same tensor: kept
    w.add_(1)
    assert bk._memo_layout((w,), make) == 2          # changed in place
    other = torch.zeros((4, 4), dtype=torch.int8)
    assert bk._memo_layout((other,), make) == 3      # another tensor
    key = id(other)
    del other
    assert key not in bk._LAYOUTS                    # dropped with it


def test_per_stage_scheduler_lays_out_once_per_model(monkeypatch):
    """The per-stage backend lays out B.4's three binary conv stages and
    B.5's two fc layers when it is built, and never again, over hops,
    emit hops and a peek."""
    calls = []

    def counting(fn):
        def wrapped(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return wrapped

    # B.4's layout and B.5's (whose layers go through fragment_layout)
    monkeypatch.setattr(bk, "prepare_step_weights",
                        counting(bk.prepare_step_weights))
    monkeypatch.setattr(bk, "fragment_layout", counting(bk.fragment_layout))
    spec = kws.build_kws_smoke_spec()
    plan = plan_stream(spec, hop_frames=1)
    rng = np.random.default_rng(2)
    weights, thresholds = {}, {}
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, GAPSpec):
            continue
        k = layer.k if isinstance(layer, Conv1DSpec) else 1
        weights[i] = rng.integers(-1, 2, (k * layer.cin, layer.cout)).astype(
            np.int8)
        thresholds[i] = (np.round(rng.normal(0, 2, layer.cout)),
                         rng.random(layer.cout) < 0.3)
    s = StreamScheduler(spec, weights, thresholds, capacity=2, hop_frames=1,
                        backend="per_stage", device="cpu")
    binary = sum(1 for st in plan.convs if st.in_bits == 1)
    assert len(calls) == binary + len(plan.fcs)
    built = len(calls)
    sid = s.add_stream()
    s.push_audio(sid, rng.integers(0, 256, plan.prime_samples
                                   + 4 * plan.hop_samples, dtype=np.uint8))
    with dispatch.counting() as launched:
        hops = s.drain()
        s.peek(sid)
    assert hops == 4 and launched()[bk.TAIL_KERNEL] >= hops
    assert len(calls) == built
