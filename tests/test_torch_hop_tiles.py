"""Port, hop kernel host functions: the slot-block choice
(``hop_megakernel.slot_block``), the S-slot shared-memory layout
(``cta_layout``, ``smem_layout``) and its refusal above 232,448 B, the
launch shape memoized from them (``_launch_shape``), the weight layout
(``prepare_hop_weights``) and B.3's launch shape
(``conv_kernels.bitserial_tiles``).

The CUDA kernels run only on the card, where ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold them against their plain versions.  Here a
plain-torch emulation of the hop kernel's GEMMs -- its u8 windows at their
row pitch, the A rows it reads from them (clamped rows, padded depth and
all), the B fragments it reads from the laid-out weights, and the
``in_offset * sum(w)`` fold -- must give ``hop_megakernel_plain``'s raw
conv bit for bit, and every byte it reads must lie inside the buffer
``smem_layout`` sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
from repro_torch.kernels import conv_kernels as bk
from repro_torch.kernels import hop_megakernel as mk
from repro_torch.models import kws
from repro_torch.stream.state import plan_stream


def _multibit_smoke():
    """The smoke spec with conv stage 1 taking an 8-bit offset-binary
    input (``ROADMAP.md`` C.1)."""
    spec = kws.build_kws_smoke_spec()
    layers = list(spec.layers)
    layers[1] = dataclasses.replace(layers[1], in_bits=8, in_offset=128)
    return dataclasses.replace(spec, layers=tuple(layers), name="multibit")


# a random-style geometry: stride 2 at l0 (A rows not 4-byte aligned),
# cin 48 (linear rows) and 96 (padded rows), a 4-channel output (one
# ragged n-tile), a 4-bit input and pool 4
RANDOM = CNN1DSpec(
    in_len=4000, in_channels=1, in_bits=4, name="rand",
    layers=(
        Conv1DSpec(1, 48, k=5, stride=2, pad=3, in_bits=4, in_offset=8,
                   name="l0"),
        Conv1DSpec(48, 96, k=3, pad=1, pool=2, name="b1"),
        Conv1DSpec(96, 4, k=5, pad=2, pool=4, name="b2"),
        GAPSpec(4, name="gap"),
        FCSpec(4, 16, in_bits=8, name="fc1"),
        FCSpec(16, 12, out_raw=True, name="fc2"),
    ),
)

PLANS = {
    "kws-hf8": (kws.build_kws_spec(), 8),
    "smoke-hf1": (kws.build_kws_smoke_spec(), 1),
    "multibit-hf1": (_multibit_smoke(), 1),
    "random-hf2": (RANDOM, 2),
}


def _geoms(name):
    spec, hf = PLANS[name]
    plan = plan_stream(spec, hop_frames=hf)
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_dims = [(f.cin, f.cout) for f in plan.fcs]
    return plan, geoms, fc_dims


# ---------------------------------------------------------------------------
# Slot blocks and the shared-memory layout
# ---------------------------------------------------------------------------

def _waves(b, lay, sms=mk.H100_SMS):
    per_sm = min(2048 // mk.THREADS, mk.SM_SMEM // (
        lay.smem + mk.STATIC_SMEM + mk.CTA_RESERVED_SMEM))
    return -(-(-(-b // lay.slots)) // (sms * per_sm))


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("b", [1, 37, 200, 256, 257, 1000, 4096])
def test_slot_block_takes_fewest_waves_then_smallest(name, b):
    plan, geoms, fc = _geoms(name)
    lay = mk.slot_block(b, geoms, fc, plan.gap_channels)
    assert lay.smem <= mk.DYNAMIC_SMEM
    fits = []
    for s in mk.SLOT_BLOCKS:
        try:
            fits.append(mk.cta_layout(geoms, fc, plan.gap_channels, s))
        except ValueError:
            pass
    best = min(_waves(b, x) for x in fits)
    assert _waves(b, lay) == best
    assert lay.slots == min(x.slots for x in fits if _waves(b, x) == best)


@pytest.mark.parametrize("b,slots", [(1, 1), (200, 2), (256, 2), (257, 2),
                                     (1000, 4)])
def test_slot_block_on_the_kws_plan(b, slots):
    """The main path (B=256) takes blocks of two slots: one wave of 128
    CTAs where single slots would need two."""
    plan, geoms, fc = _geoms("kws-hf8")
    assert mk.slot_block(b, geoms, fc, plan.gap_channels).slots == slots


# every plan at every slot block, but eight full-width KWS slots, which do
# not fit (test_kws_slot_blocks_trade_chunk_size_for_slots)
LAYOUTS = [(n, s) for n in PLANS for s in mk.SLOT_BLOCKS
           if (n, s) != ("kws-hf8", 8)]


@pytest.mark.parametrize("name,slots", LAYOUTS, ids=str)
def test_cta_layout_adds_up(name, slots):
    plan, geoms, fc = _geoms(name)
    lay = mk.cta_layout(geoms, fc, plan.gap_channels, slots)
    win0, bin_, frm, fc_pitch, slot_bytes = mk.smem_layout(
        geoms, fc, plan.gap_channels)
    state = mk.state_offsets(geoms, plan.gap_channels)[-1]
    assert slot_bytes == win0 + 2 * bin_ + frm + -(-4 * state // 16) * 16
    assert all(x % 16 == 0 for x in (win0, bin_, frm, fc_pitch))
    ksteps = max([-(-g.k * g.cin // 32) for g in geoms]
                 + [-(-cin // 32) for cin, _ in fc])
    assert lay.ring_bytes == lay.chunk_tiles * ksteps * 256
    assert lay.fc_bytes == mk.FC_ROWS * fc_pitch
    assert fc_pitch >= max([plan.gap_channels] + [d for x in fc for d in x])
    assert lay.sa_bytes >= 12 * max([g.cout for g in geoms]
                                    + [c for _, c in fc])
    assert lay.smem == 2 * lay.ring_bytes + slots * slot_bytes \
        + 2 * lay.fc_bytes + lay.sa_bytes <= mk.DYNAMIC_SMEM
    assert mk.DYNAMIC_SMEM + mk.STATIC_SMEM == mk.MAX_SMEM == 232448
    # the largest chunk that fits is taken
    bigger = [c for c in mk.CHUNK_TILES if c > lay.chunk_tiles]
    for c in bigger:
        assert 2 * c * ksteps * 256 + slots * slot_bytes \
            + 2 * lay.fc_bytes + lay.sa_bytes > mk.DYNAMIC_SMEM


def test_kws_slot_blocks_trade_chunk_size_for_slots():
    """At full KWS width two slots stream chunks of 8 n-tiles, four slots
    chunks of 4, and eight slots do not fit beside the ring at all."""
    plan, geoms, fc = _geoms("kws-hf8")
    assert mk.cta_layout(geoms, fc, plan.gap_channels, 2).chunk_tiles == 8
    assert mk.cta_layout(geoms, fc, plan.gap_channels, 4).chunk_tiles == 4
    with pytest.raises(ValueError, match="228352 B"):
        mk.cta_layout(geoms, fc, plan.gap_channels, 8)


def test_cta_layout_refuses_above_the_block_limit():
    plan, geoms, fc = _geoms("kws-hf8")
    wide = list(geoms)
    wide[1] = dataclasses.replace(wide[1], n_in=700)   # 56 KB windows
    with pytest.raises(ValueError, match="228352 B"):
        mk.cta_layout(tuple(wide), fc, plan.gap_channels, 2)
    # one slot still fits, so the choice falls back to it
    one = mk.slot_block(256, tuple(wide), fc, plan.gap_channels)
    assert one.slots == 1 and one.smem <= mk.DYNAMIC_SMEM
    with pytest.raises(ValueError, match="slots"):
        mk.cta_layout(geoms, fc, plan.gap_channels, mk.MAX_SLOTS + 1)
    wide[1] = dataclasses.replace(wide[1], n_in=4000)
    with pytest.raises(ValueError, match="no slot block"):
        mk.slot_block(256, tuple(wide), fc, plan.gap_channels)


def test_window_modes():
    _, geoms, _ = _geoms("random-hf2")
    assert [mk.a_mode(g) for g in geoms] == [2, 1, 0]
    assert [mk.window_pitch(g) for g in geoms] == [1, 48, 112]
    _, geoms, _ = _geoms("kws-hf8")
    assert [mk.a_mode(g) for g in geoms] == [1, 0, 0, 0]
    assert [mk.window_pitch(g) for g in geoms] == [1, 80, 144, 272]


def test_kernel_refuses_what_u8_cannot_hold():
    """Stage 0 feeds the tensor cores u8 too: a wider bit-serial input is
    refused with its reason; so is a raw fc layer before the last."""
    _, geoms, _ = _geoms("smoke-hf1")
    wide = (dataclasses.replace(geoms[0], in_bits=12, in_offset=2048),
            *geoms[1:])
    with pytest.raises(ValueError, match="in_bits <= 8"):
        mk.check_geoms(wide, (False, True))
    with pytest.raises(ValueError, match="last fc layer"):
        mk.check_geoms(geoms, (True, True))
    mk.check_geoms(geoms, (False, True))
    gap = torch.zeros((2, 88), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="in_bits <= 8"):
        mk.hop_megakernel_packed(None, None, (), (), gap, (), (), (),
                                 geoms=wide, emit=False)


# ---------------------------------------------------------------------------
# The weight layout, through an emulation of the kernel's GEMM reads
# ---------------------------------------------------------------------------

def _b_matrix(frag, n, k):
    """The (n, kp) int matrix the kernel's B fragment reads give: lane
    4 g + t of n-tile j, k-step s holds columns 32 s + 4 t + {0..3} (bytes
    0-3) and 32 s + 16 + 4 t + {0..3} (bytes 4-7) of row 8 j + g."""
    nt, ks = frag.shape[-4:-2]
    out = torch.zeros((nt * 8, ks * 32), dtype=torch.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for byte in range(8):
            h, e = divmod(byte, 4)
            out[g::8, 16 * h + 4 * t + e::32] = frag[:, :, lane, byte].long()
    assert not out[n:].any() and not out[:, k:].any()   # zero padding
    return out[:n]


def _a_rows(buf, g, n_pos, kp):
    """The (n_pos padded to 16, kp) A rows the kernel reads from one
    slot's u8 window, rows past n_pos clamped to the last, and the highest
    byte offset it touches."""
    pitch, mode = mk.window_pitch(g), mk.a_mode(g)
    rows = -(-n_pos // 16) * 16
    kk = torch.arange(kp)
    a = torch.empty((rows, kp), dtype=torch.int64)
    top = 0
    for r in range(rows):
        p = min(r, n_pos - 1)
        if mode == 0:
            addr = (p * g.stride + kk // g.cin) * pitch + kk % g.cin
        else:
            addr = p * g.stride * g.cin + kk
        a[r] = buf[addr].long()
        top = max(top, int(addr.max()))
    return a[:n_pos], top


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("flush", [False, True])
def test_laid_out_weights_give_the_plain_raw_conv(name, flush):
    plan, geoms, fc = _geoms(name)
    rng = np.random.default_rng(len(name) + flush)
    win0_bytes, bin_bytes, *_ = mk.smem_layout(geoms, fc, plan.gap_channels)
    b = 2
    ws = [torch.as_tensor(rng.integers(-1, 2, (g.k, g.cin, g.cout)),
                          dtype=torch.int8) for g in geoms]
    hw = mk.prepare_hop_weights(ws)
    for i, g in enumerate(geoms):
        n_pos = g.flush_conv if flush else g.n_conv
        if n_pos <= 0:
            continue
        n_rows = g.tail + (g.flush_in + g.pad if flush else g.n_in)
        hi = 256 if g.in_bits > 1 else 2
        window = torch.as_tensor(rng.integers(0, hi, (b, n_rows, g.cin),
                                              dtype=np.int32))
        if flush and g.pad:
            window[:, n_rows - g.pad:] = g.in_offset if g.in_bits > 1 else 0
        want = mk._conv_raw(g, ws[i].int(), window, n_pos)
        size = win0_bytes if i == 0 else bin_bytes
        pitch, kp = mk.window_pitch(g), -(-g.k * g.cin // 32) * 32
        wt = _b_matrix(hw.conv[i], g.cout, g.k * g.cin)
        assert torch.equal(hw.wsum[i], ws[i].int().sum((0, 1)))
        for s in range(b):
            # the kernel's window: garbage everywhere but the rows it fills
            buf = torch.as_tensor(rng.integers(0, 256, size, dtype=np.int64))
            vals = window[s].long()
            if g.in_bits > 1:
                vals = vals & ((1 << g.in_bits) - 1)
            for r in range(n_rows):
                buf[r * pitch:r * pitch + g.cin] = vals[r] & 255
            a, top = _a_rows(buf, g, n_pos, kp)
            assert top < size
            raw = a @ wt.T
            if g.in_bits > 1:
                raw = raw - g.in_offset * hw.wsum[i].long()
            assert torch.equal(raw.int(), want[s]), (name, i, s)


@pytest.mark.parametrize("name", list(PLANS))
def test_laid_out_fc_weights_give_the_plain_classifier(name):
    """fc1 reads the u8 GAP counts, fc2 the u8 SA bits, one row per slot
    at the classifier's pitch; both layouts contract to the plain
    classifier's logits."""
    plan, geoms, fc = _geoms(name)
    rng = np.random.default_rng(7)
    *_, fc_pitch, _ = mk.smem_layout(geoms, fc, plan.gap_channels)
    fc_ws = [torch.as_tensor(rng.integers(-1, 2, dims), dtype=torch.int8)
             for dims in fc]
    thrs = [torch.as_tensor(np.round(rng.normal(0, 20, d[1])).astype(
        np.float32)) for d in fc]
    flips = [torch.as_tensor((rng.random(d[1]) < 0.3).astype(np.int32))
             for d in fc]
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    hw = mk.prepare_hop_weights((), fc_ws)
    gap = torch.as_tensor(rng.integers(0, 256, (5, plan.gap_channels),
                                       dtype=np.int32))
    want = mk._classifier(gap, [w.int() for w in fc_ws], thrs, flips, fc_raw)
    h = gap.long()
    for j, (cin, cout) in enumerate(fc):
        kp = -(-cin // 32) * 32
        assert kp <= fc_pitch - 16
        buf = torch.as_tensor(rng.integers(0, 256, (mk.FC_ROWS, fc_pitch)))
        buf[:5, :cin] = h
        raw = buf[:5, :kp] @ _b_matrix(hw.fc[j], cout, cin).T
        h = raw if fc_raw[j] else mk._sa(raw, thrs[j], flips[j]).long()
    assert torch.equal(h.int(), want)


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("b", [1, 32, 128, 256])
def test_launch_shape_memo_equals_fresh(name, b):
    """``_launch_shape``, which a launch takes its shape from, memoizes
    ``state_offsets``, ``smem_layout``, ``sa_columns`` and ``slot_block``
    (or ``cta_layout`` of a forced slot block): on a steady hop (no fc
    layers) and an emit hop its results equal fresh calls, and a second
    call returns the memoized object."""
    plan, geoms, fc = _geoms(name)
    gap = plan.gap_channels
    for fc_dims in ((), tuple(fc)):
        for slots in (None, 1):
            got = mk._launch_shape(geoms, fc_dims, gap, b, mk.H100_SMS,
                                   slots)
            lay = (mk.slot_block(b, geoms, list(fc_dims), gap)
                   if slots is None
                   else mk.cta_layout(geoms, list(fc_dims), gap, slots))
            assert got == (mk.state_offsets(geoms, gap),
                           mk.smem_layout(geoms, list(fc_dims), gap),
                           mk.sa_columns(geoms, list(fc_dims)), lay)
            assert mk._launch_shape(geoms, fc_dims, gap, b, mk.H100_SMS,
                                    slots) is got


def test_prepared_weights_keep_the_reference_operands_and_pool_axis():
    rng = np.random.default_rng(3)
    ws = [torch.as_tensor(rng.integers(-1, 2, (2, 3, 16, 40)),
                          dtype=torch.int8)]
    fc_ws = [torch.as_tensor(rng.integers(-1, 2, (2, 40, 12)),
                             dtype=torch.int8)]
    hw = mk.prepare_hop_weights(ws, fc_ws)
    assert hw.ws[0] is ws[0] and hw.fc_ws[0] is fc_ws[0]
    assert hw.conv[0].shape == (2, 5, 2, 32, 8)
    assert hw.fc[0].shape == (2, 2, 2, 32, 8)
    assert hw.wsum[0].shape == (2, 40) and hw.wsum[0].dtype == torch.int32
    for m in range(2):
        one = mk.prepare_hop_weights([ws[0][m]], [fc_ws[0][m]])
        assert torch.equal(one.conv[0], hw.conv[0][m])
        assert torch.equal(one.fc[0], hw.fc[0][m])


# ---------------------------------------------------------------------------
# B.3's launch shape
# ---------------------------------------------------------------------------

# (B, l_out, cin, k, stride, cout), positions per thread, per CTA, channels
BITSERIAL = [((256, 64, 1, 19, 8, 64), 4, 64, 64),     # the hop's l0
             ((1, 2000, 1, 19, 8, 64), 1, 16, 64),     # the utterance's l0
             ((200, 64, 1, 19, 8, 64), 4, 64, 64),
             ((48, 13, 1, 7, 2, 32), 1, 32, 32),
             ((2, 9, 16, 3, 1, 32), 1, 32, 32),
             ((4, 30, 256, 5, 1, 256), 1, 21, 48)]


@pytest.mark.parametrize("shape,ppt,pb,cb", BITSERIAL, ids=str)
def test_bitserial_tiles(shape, ppt, pb, cb):
    b, l_out, cin, k, stride, cout = shape
    t = bk.bitserial_tiles(*shape)
    assert (t.ppt, t.pb, t.cb) == (ppt, pb, cb)
    kw = -(-k * cin // 4)
    assert t.cb % 4 == 0 and kw * t.cb * 4 <= bk.BITSERIAL_WEIGHT_SMEM
    rows = (min(t.pb, l_out) - 1) * stride + k
    assert t.smem == kw * t.cb * 4 + -(-rows * cin // 4) * 4 + 8
    assert t.smem <= mk.MAX_SMEM
    # a CTA's threads cover its channel groups x position groups
    assert (t.cb // 4) * (t.pb // t.ppt) <= bk.THREADS


def test_bitserial_kernel_refuses_wide_codes():
    x = torch.zeros((1, 40, 1), dtype=torch.int32, device="meta")
    w = torch.zeros((19, 1, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="bits <= 8"):
        bk._bitserial_cuda(x, w, None, bits=12, stride=8, l_out=3)
