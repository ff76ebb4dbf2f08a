"""Port parity, per-stage backend: the packing helpers, the three
per-stage kernel entry points (``bitserial_conv1d_batched``,
``bnn_conv1d_batched`` raw and ``sa``, ``classifier_tail``) and
``StreamScheduler(backend="per_stage")`` on the CPU against the
reference's ``kernels/ops.py`` (Pallas in interpret mode) and its
``backend="pallas"`` and ``"jnp"`` schedulers, all bit for bit (tolerance
0; posteriors to float32 rounding, as softmax is computed by two
libraries).  The CUDA kernels are held against the plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.kernels import ops as ref_ops
from repro.models import kws as ref_kws
from repro_torch.core import quant
from repro_torch.kernels import conv_kernels as bk
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as port_ops


def _T(x):
    return torch.as_tensor(np.asarray(x))


def _thresholds(rng, lo, hi, w):
    """Integer thresholds near the middle of each channel's accumulator
    range, a few at ±inf (an exported ``a == 0`` channel), random flips."""
    cout = w.shape[-1]
    wsum = w.reshape(-1, cout).sum(0)
    thr = np.round((lo + hi) / 2 * wsum + rng.integers(-3, 4, cout))
    thr = thr.astype(np.float32)
    thr[rng.random(cout) < 0.2] = np.inf
    thr[rng.random(cout) < 0.1] = -np.inf
    return thr, (rng.random(cout) < 0.4).astype(np.int32)


# ---------------------------------------------------------------------------
# Packing helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 40), (2, 64), (1, 2, 7, 96)],
                         ids=str)
def test_pack_activations_matches_reference(shape):
    x = np.random.default_rng(len(shape)).integers(0, 2, shape)
    want = np.asarray(ref_ops.pack_activations(jnp.asarray(x)))
    got = port_ops.pack_activations(_T(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    lanes = quant.unpack_bits(got)[..., :shape[-1]]
    np.testing.assert_array_equal(lanes.numpy(), x)


@pytest.mark.parametrize("shape", [(40, 8), (3, 64, 5), (2, 3, 33, 4)],
                         ids=str)
def test_pack_weight_planes_matches_reference(shape):
    w = np.random.default_rng(len(shape)).integers(-1, 2, shape)
    want = ref_ops.pack_weight_planes(jnp.asarray(w))
    got = port_ops.pack_weight_planes(_T(w))
    for g, r in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(r))


def test_pack_bits_wraps_bit_31():
    """Channel c sits at bit c % 32 of word c // 32; a word with bit 31
    set is the negative int32 of the same pattern."""
    x = torch.zeros(64, dtype=torch.int32)
    x[31] = x[32] = 1
    words = quant.pack_bits(x)
    assert words.tolist() == [-2 ** 31, 1]
    assert words.view(torch.uint32).numpy().tolist() == [2 ** 31, 1]


# ---------------------------------------------------------------------------
# Per-stage kernel entry points (B.3-B.5)
# ---------------------------------------------------------------------------

# (bits, stride, pad, B, tenant models, slot block)
BITSERIAL = [(8, 8, 9, 3, 1, None), (4, 2, 0, 3, 1, None),
             (2, 4, 3, 3, 1, None), (8, 4, 2, 11, 2, 4)]


@pytest.mark.parametrize("bits,stride,pad,b,k_models,bb", BITSERIAL,
                         ids=[f"bits{c[0]}-s{c[1]}-p{c[2]}-b{c[3]}-k{c[4]}"
                              for c in BITSERIAL])
def test_bitserial_conv1d_batched_matches_reference(bits, stride, pad, b,
                                                    k_models, bb):
    rng = np.random.default_rng(bits * 10 + stride)
    l, cin, cout, k = 75, 2, 5, 7
    x = rng.integers(0, 1 << bits, (b, l, cin))
    shape = (k, cin, cout) if k_models == 1 else (k_models, k, cin, cout)
    w = rng.integers(-1, 2, shape).astype(np.int32)
    offset = 1 << (bits - 1)
    # tenants mixed inside a slot block: the kernel takes the block's
    # first row, the offset fold each slot's own row, as in the reference
    mi = (rng.integers(0, k_models, b).astype(np.int32) if k_models > 1
          else None)
    kw = dict(bits=bits, offset=offset, stride=stride, pad=pad, bb=bb)
    want = ref_ops.bitserial_conv1d_batched(
        jnp.asarray(x, jnp.uint32), jnp.asarray(w),
        None if mi is None else jnp.asarray(mi), interpret=True, **kw)
    for weights in (_T(w), port_ops.conv_weights(_T(w))):
        with dispatch.counting() as launched:
            got = port_ops.bitserial_conv1d_batched(
                _T(x), weights, None if mi is None else _T(mi), **kw)
        assert launched() == {bk.BITSERIAL_KERNEL: 1}
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (mode, pool, stride, pad, B, tenant models, slot block)
CONV = [("raw", 1, 1, 1, 3, 1, None), ("sa", 1, 1, 0, 3, 1, None),
        ("sa", 2, 1, 1, 5, 1, None), ("sa", 2, 2, 2, 11, 1, None),
        ("sa", 4, 1, 0, 2, 1, None), ("raw", 1, 1, 1, 11, 2, None),
        ("raw", 1, 2, 0, 9, 3, 4)]


@pytest.mark.parametrize(
    "mode,pool,stride,pad,b,k_models,bb", CONV,
    ids=[f"{c[0]}-pool{c[1]}-s{c[2]}-p{c[3]}-b{c[4]}-k{c[5]}" for c in CONV])
def test_bnn_conv1d_batched_matches_reference(mode, pool, stride, pad, b,
                                              k_models, bb):
    rng = np.random.default_rng(b * 7 + pool)
    l, cin, cout, k = 17, 40, 6, 3
    x = rng.integers(0, 2, (b, l, cin))
    shape = (k, cin, cout) if k_models == 1 else (k_models, k, cin, cout)
    w = rng.integers(-1, 2, shape).astype(np.int32)
    thr, flip = _thresholds(rng, 0, 1, w)
    mi = (rng.integers(0, k_models, b).astype(np.int32) if k_models > 1
          else None)
    kw = dict(stride=stride, pad=pad, pool=pool, mode=mode, bb=bb)
    want = np.asarray(ref_ops.bnn_conv1d_batched(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(thr), jnp.asarray(flip),
        None if mi is None else jnp.asarray(mi), interpret=True, **kw))
    with dispatch.counting() as launched:
        got = port_ops.bnn_conv1d_batched(
            _T(x), _T(w), _T(thr), _T(flip), None if mi is None else _T(mi),
            **kw)
    assert launched() == {bk.CONV_STEP_KERNEL: 1}
    assert got.dtype == (torch.uint32 if mode == "sa" else torch.int32)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_bnn_conv1d_batched_refuses_pooled_sa():
    w = torch.zeros((2, 3, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="raw"):
        port_ops.bnn_conv1d_batched(
            torch.zeros((2, 5, 8), dtype=torch.int32), w, torch.zeros(4),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), mode="sa")


# (fc widths, out_raw per layer, B, tenant models, slot block)
TAIL = [((20, 16, 12), (False, True), 5, 1, None),
        ((20, 24, 16, 12), (False, False, True), 3, 1, None),
        ((20, 16, 12), (False, True), 11, 2, 4)]


@pytest.mark.parametrize("dims,out_raw,b,k_models,bb", TAIL,
                         ids=[f"{len(c[1])}fc-b{c[2]}-k{c[3]}" for c in TAIL])
def test_classifier_tail_matches_reference(dims, out_raw, b, k_models, bb):
    rng = np.random.default_rng(b + len(dims))
    gap = rng.integers(0, 400, (b, dims[0])).astype(np.int32)
    ws, thrs, flips = [], [], []
    for j, raw in enumerate(out_raw):
        lead = () if k_models == 1 else (k_models,)
        w = rng.integers(-1, 2, lead + (dims[j], dims[j + 1])).astype(
            np.int32)
        lo_hi = (0, 255) if j == 0 else (0, 1)
        per = [_thresholds(rng, *lo_hi, w[m] if lead else w)
               for m in range(k_models)]
        thr = np.stack([p[0] for p in per]) if lead else per[0][0]
        flip = np.stack([p[1] for p in per]) if lead else per[0][1]
        ws.append(w), thrs.append(thr), flips.append(flip)
    mi = (rng.integers(0, k_models, b).astype(np.int32) if k_models > 1
          else None)
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    want = ref_ops.classifier_tail(
        jnp.asarray(gap), J(ws), J(thrs), J(flips),
        None if mi is None else jnp.asarray(mi), out_raw=out_raw, bb=bb,
        interpret=True)
    L = lambda xs: [_T(x) for x in xs]  # noqa: E731
    with dispatch.counting() as launched:
        got = port_ops.classifier_tail(
            _T(gap), L(ws), L(thrs), L(flips),
            None if mi is None else _T(mi), out_raw=out_raw, bb=bb)
    assert launched() == {bk.TAIL_KERNEL: 1}
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_non_cuda_device_raises_instead_of_falling_back():
    """Only CPU tensors take the plain versions; any other device goes to
    the CUDA kernels, which refuse what they cannot launch."""
    meta = dict(device="meta", dtype=torch.int32)
    w = torch.zeros((3, 8, 4), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        port_ops.bnn_conv1d_batched(torch.zeros((2, 6, 8), **meta), w,
                                    mode="raw")
    with pytest.raises(ValueError, match="CUDA"):
        port_ops.bitserial_conv1d_batched(torch.zeros((2, 6, 8), **meta), w,
                                          bits=8, offset=128)
    with pytest.raises(ValueError, match="CUDA"):
        port_ops.classifier_tail(torch.zeros((2, 8), **meta),
                                 [torch.zeros((8, 4), **meta)], [None],
                                 [None], out_raw=(True,))


# ---------------------------------------------------------------------------
# The scheduler's per-stage backend
# ---------------------------------------------------------------------------

def _scheduler_spec(name):
    if name == "smoke":
        return ref_kws.build_kws_smoke_spec(), 1
    return cases.random_spec(int(name[4:]))


# rand1: bit-serial l0 (8 bits), pool 2, no flush conv (zero-width flush
# work launches nothing); rand4: three convs, pool 2 and 4, pool phases.
# Both have 8-bit first layers: the reference's jnp backend subtracts the
# offset from the raw u8 code where its pallas backend masks it to in_bits,
# so the two agree on u8 audio only at in_bits = 8.
@pytest.mark.parametrize("name,emit", [("smoke", True), ("rand1", True),
                                       ("rand4", False)])
def test_per_stage_scheduler_matches_reference(name, emit):
    spec, hf = _scheduler_spec(name)
    weights, thresholds = cases.exported(spec)
    assert spec.layers[0].in_bits == 8
    pair = cases.SchedulerPair(spec, weights, thresholds, "per_stage", emit,
                               ref_backends=("pallas", "jnp"), hop_frames=hf)
    cases.drive_scheduler(pair, seed=3, min_hops=10)


def test_per_stage_launch_accounting_on_the_kws_plan():
    """On the full-width KWS plan at hop_frames=8: 4 launches per steady
    hop, 9 per emit hop (4 stages, 4 flush convs, the classifier) and 5
    per standalone finalization — the reference's counts."""
    from repro.stream.scheduler import _BatchedModel as RefModel
    from repro.stream.state import plan_stream as ref_plan_stream
    from repro_torch.stream import StreamScheduler

    spec = ref_kws.build_kws_spec()
    weights, thresholds = cases.exported(spec)
    port = StreamScheduler(cases.port_spec(spec), weights, thresholds,
                           capacity=2, hop_frames=8, backend="per_stage",
                           device="cpu")
    model = port._model
    ref_model = RefModel(ref_plan_stream(spec, hop_frames=8), weights,
                         thresholds, backend="pallas", interpret=True)
    assert (model.dispatches_per_hop(False), model.dispatches_per_hop(True),
            model.dispatches_per_finalize()) == (4, 9, 5)
    for emit in (False, True):
        assert model.dispatches_per_hop(emit) == \
            ref_model.dispatches_per_hop(emit)
    assert cases.expected_launches(port, emit=True) == {
        bk.BITSERIAL_KERNEL: 2, bk.CONV_STEP_KERNEL: 6, bk.TAIL_KERNEL: 1}
    assert cases.expected_launches(port, emit=False, peek=True) == {
        bk.BITSERIAL_KERNEL: 1, bk.CONV_STEP_KERNEL: 3, bk.TAIL_KERNEL: 1}
