"""Port parity, kernel library: the plain oracles (``kernels/ref.py``),
the quantization helpers, the single-stream entry points
(``ops.twm_linear`` raw and ``sa``, ``ops.twm_linear_mxu``,
``ops.bnn_conv1d``, ``ops.bitserial_conv1d``) and ``ops.pick_path`` on
the CPU against the reference's ``repro.kernels`` (Pallas in interpret
mode, its CPU default), the kernels' plain versions against the port's
oracles, the entry points' device rule, and one utterance through the
library (``models.kws.offline_logits``) against the reference's offline
executor.  Tolerance: bit-equality throughout.  The CUDA kernels are held
against their plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.core import compiler, executor
from repro.core import quant as ref_quant
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import kws as ref_kws
from repro_torch import kernels as port_kernels
from repro_torch.core import quant
from repro_torch.kernels import conv_kernels as bk
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import twm_matmul as tm
from repro_torch.models import kws as port_kws


def _T(x):
    return torch.as_tensor(np.asarray(x))


def _eq(got: torch.Tensor, want) -> None:
    """Bit-equal values and the reference's dtype (``torch.uint32`` for
    its uint32)."""
    want = np.asarray(want)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _dense(m, k, n, seed):
    """The reference tests' dense operands: {0,1} uint32 activations,
    ternary int32 weights, float32 thresholds, bool flips."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (m, k)).astype(np.uint32),
            rng.integers(-1, 2, (k, n)).astype(np.int32),
            rng.normal(0, 3, (n,)).astype(np.float32),
            rng.integers(0, 2, (n,)).astype(bool))


def _conv_case(l, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (l, cin)).astype(np.uint32),
            rng.integers(-1, 2, (k, cin, cout)).astype(np.int32),
            rng.normal(0, 2, (cout,)).astype(np.float32),
            rng.integers(0, 2, (cout,)).astype(bool))


# ---------------------------------------------------------------------------
# Oracles and quantization helpers
# ---------------------------------------------------------------------------

def _oracle_cases():
    """(name, fn(ref module, to-array) -> result) per oracle."""
    x, w, thr, flip = _dense(33, 513, 65, 1)
    xc, wc, tc, fc = _conv_case(100, 24, 40, 3, 2)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 256, (160, 2)).astype(np.uint32)
    wb = rng.integers(-1, 2, (19, 2, 16)).astype(np.int32)
    mcodes = rng.integers(0, 256, (3, 96)).astype(np.uint32)
    wm = rng.integers(-1, 2, (96, 12)).astype(np.int32)
    xb = rng.integers(0, 2, (4, 40, 24)).astype(np.uint32)
    words = rng.integers(0, 2 ** 32, (9, 5), dtype=np.uint64).astype(
        np.uint32)
    wpk = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64).astype(np.uint32)
    wnk = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64).astype(np.uint32)
    ybits = rng.integers(0, 2, (37, 6)).astype(np.uint32)
    return {
        "ref_twm_matmul": lambda r, a: r.ref_twm_matmul(a(x), a(w)),
        "ref_twm_matmul_sa": lambda r, a: r.ref_twm_matmul_sa(
            a(x), a(w), a(thr), a(flip)),
        "_shifted_views": lambda r, a: r._shifted_views(a(xc), 7, 2, 3),
        "conv1d_out_len": lambda r, a: r.conv1d_out_len(100, 7, 2, 3),
        "ref_bnn_conv1d": lambda r, a: r.ref_bnn_conv1d(a(xc), a(wc), 2, 1),
        "ref_bnn_conv1d_sa": lambda r, a: r.ref_bnn_conv1d_sa(
            a(xc), a(wc), a(tc), a(fc), 1, 1, 4),
        "ref_bnn_conv1d_batched": lambda r, a: r.ref_bnn_conv1d_batched(
            a(xb), a(wc), 1, 1),
        "ref_maxpool1d": lambda r, a: r.ref_maxpool1d(a(ybits), 4),
        "ref_gap_counts": lambda r, a: r.ref_gap_counts(a(ybits)),
        "ref_bitserial_conv1d": lambda r, a: r.ref_bitserial_conv1d(
            a(codes), a(wb), 8, 128, 8, 9),
        "ref_bitserial_matmul": lambda r, a: r.ref_bitserial_matmul(
            a(mcodes), a(wm), 8, 17),
        "ref_popcount_gemm_packed": lambda r, a: r.ref_popcount_gemm_packed(
            a(words), a(wpk), a(wnk)),
    }


ORACLES = list(_oracle_cases())


@pytest.mark.parametrize("name", ORACLES)
def test_oracle_matches_reference(name):
    fn = _oracle_cases()[name]
    want = fn(ref_ref, jnp.asarray)
    got = fn(port_ref, _T)
    if isinstance(want, int):
        assert got == want
    else:
        _eq(got, want)


def test_quant_helpers_match_reference():
    rng = np.random.default_rng(4)
    w = rng.integers(-1, 2, (5, 64)).astype(np.int32)
    pos, neg = quant.ternary_planes(_T(w))
    _eq(quant.planes_to_ternary(pos, neg), ref_quant.planes_to_ternary(
        *ref_quant.ternary_planes(jnp.asarray(w))))
    bits = rng.integers(0, 2, (3, 96, 2)).astype(np.uint8)
    np.testing.assert_array_equal(quant.np_pack_bits(bits, axis=1),
                                  ref_quant.np_pack_bits(bits, axis=1))
    assert quant.np_pack_bits(bits, axis=1).dtype == np.uint32
    gamma = rng.normal(0, 1, 16).astype(np.float32)
    gamma[:2] = 0
    beta, mean = (rng.normal(0, 3, 16).astype(np.float32) for _ in range(2))
    var = rng.uniform(0.1, 4, 16).astype(np.float32)
    thr, flip = quant.fold_bn_to_threshold(*(_T(v) for v in (gamma, beta,
                                                            mean, var)))
    rthr, rflip = ref_quant.fold_bn_to_threshold(
        *(jnp.asarray(v) for v in (gamma, beta, mean, var)))
    _eq(thr, rthr)
    _eq(flip, rflip)
    s = rng.integers(-20, 20, (7, 16)).astype(np.float32)
    _eq(quant.apply_threshold(_T(s), thr, flip),
        ref_quant.apply_threshold(jnp.asarray(s), rthr, rflip))


# ---------------------------------------------------------------------------
# Entry points against repro.kernels.ops (interpret mode)
# ---------------------------------------------------------------------------

DENSE = [(1, 32, 16), (7, 100, 12), (64, 1024, 128), (33, 513, 65)]


@pytest.mark.parametrize("m,k,n", DENSE, ids=str)
@pytest.mark.parametrize("mode", ["raw", "sa"])
def test_twm_linear_matches_reference(m, k, n, mode):
    x, w, thr, flip = _dense(m, k, n, m + k)
    args = (x, w) if mode == "raw" else (x, w, thr, flip)
    want = ref_ops.twm_linear(*(jnp.asarray(a) for a in args), mode=mode)
    with dispatch.counting() as launched:
        got = port_ops.twm_linear(*(_T(a) for a in args), mode=mode)
    assert launched() == {tm.POPCOUNT_KERNEL: 1}
    _eq(got, want)


MXU = [(5, 64, 20), (16, 256, 64), (7, 100, 12), (33, 513, 65)]


@pytest.mark.parametrize("m,k,n", MXU, ids=str)
def test_twm_linear_mxu_matches_reference(m, k, n):
    x, w, thr, flip = _dense(m, k, n, m * k)
    want = ref_ops.twm_linear_mxu(*(jnp.asarray(a) for a in (x, w, thr,
                                                             flip)))
    with dispatch.counting() as launched:
        got = port_ops.twm_linear_mxu(*(_T(a) for a in (x, w, thr, flip)))
    assert launched() == {tm.MXU_KERNEL: 1}
    _eq(got, want)


# tests/test_kernels.py::test_bnn_conv1d_sweep, then its raw case
CONV = [(40, 8, 16, 3, 1, 1, 1, "sa"), (100, 24, 40, 3, 1, 1, 2, "sa"),
        (64, 16, 20, 5, 1, 2, 4, "sa"), (128, 32, 48, 7, 2, 3, 1, "sa"),
        (200, 64, 128, 3, 1, 1, 2, "sa"), (33, 8, 12, 2, 2, 0, 1, "sa"),
        (50, 16, 24, 3, 1, 1, 1, "raw")]


@pytest.mark.parametrize("l,cin,cout,k,stride,pad,pool,mode", CONV,
                         ids=["-".join(map(str, c)) for c in CONV])
def test_bnn_conv1d_matches_reference(l, cin, cout, k, stride, pad, pool,
                                      mode):
    x, w, thr, flip = _conv_case(l, cin, cout, k, l + k)
    kw = dict(stride=stride, pad=pad, pool=pool, mode=mode)
    want = ref_ops.bnn_conv1d(*(jnp.asarray(a) for a in (x, w, thr, flip)),
                              **kw)
    for weights in (_T(w), port_ops.conv_weights(_T(w))):
        with dispatch.counting() as launched:
            got = port_ops.bnn_conv1d(_T(x), weights, _T(thr), _T(flip),
                                      **kw)
        assert launched() == {bk.CONV_KERNEL: 1}
        _eq(got, want)


@pytest.mark.parametrize("bits,offset,stride", [(8, 128, 8), (4, 8, 2)])
def test_bitserial_conv1d_matches_reference(bits, offset, stride):
    rng = np.random.default_rng(bits)
    x = rng.integers(0, 2 ** bits, (160, 1)).astype(np.uint32)
    w = rng.integers(-1, 2, (19, 1, 16)).astype(np.int32)
    kw = dict(bits=bits, offset=offset, stride=stride, pad=9)
    want = ref_ops.bitserial_conv1d(jnp.asarray(x), jnp.asarray(w), **kw)
    with dispatch.counting() as launched:
        got = port_ops.bitserial_conv1d(_T(x), _T(w), **kw)
    assert launched() == {bk.BITSERIAL_KERNEL: 1}
    _eq(got, want)


def test_shifted_strided_views_match_reference():
    xq = np.random.default_rng(5).integers(0, 2 ** 31, (37, 3)).astype(
        np.int32)
    for k, stride, pad in ((3, 1, 1), (7, 2, 3), (2, 2, 0)):
        _eq(port_ops.shifted_strided_views(_T(xq), k, stride, pad),
            ref_ops.shifted_strided_views(jnp.asarray(xq), k, stride, pad))


def test_public_names_match_reference():
    import repro.kernels as ref_kernels

    assert port_kernels.__all__ == ref_kernels.__all__
    for name in port_kernels.__all__:
        assert getattr(port_kernels, name) is getattr(port_ops, name)


@pytest.mark.parametrize("m,k,n,want", [(1, 1024, 512, "popcount"),
                                        (65536, 1024, 4096, "mxu")])
def test_pick_path_regimes(m, k, n, want):
    """tests/test_kernels.py::test_pick_path_heuristic's two regimes:
    a tiny batch is bandwidth-bound (popcount), a big GEMM compute-bound
    (int8 tensor cores)."""
    assert ref_ops.pick_path(m, k, n) == want
    assert port_ops.pick_path(m, k, n) == want


# ---------------------------------------------------------------------------
# Plain versions against the port's oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(7, 100, 12), (33, 513, 65)], ids=str)
def test_twm_plain_versions_match_oracles(m, k, n):
    x, w, thr, flip = (_T(a) for a in _dense(m, k, n, 9))
    xq = port_ops.pack_activations(x.to(torch.int32))
    wp, wn = port_ops.pack_weight_planes(w)
    raw = tm.twm_matmul_plain(xq, wp, wn, mode="raw")
    assert torch.equal(raw, port_ref.ref_twm_matmul(x, w))
    assert torch.equal(raw, port_ref.ref_popcount_gemm_packed(xq, wp, wn))
    sa_want = port_ref.ref_twm_matmul_sa(x, w, thr, flip).view(torch.int32)
    thr32, flip32 = thr, flip.to(torch.int32)
    assert torch.equal(tm.twm_matmul_plain(xq, wp, wn, thr32, flip32,
                                           mode="sa"), sa_want)
    x8 = quant.pad_to_multiple(x.to(torch.int8), tm.MXU_K, 1)
    wt8 = quant.pad_to_multiple(w.to(torch.int8).t(), tm.MXU_K, 1)
    assert torch.equal(tm.twm_matmul_mxu_plain(x8, wt8, thr32, flip32),
                       sa_want)


@pytest.mark.parametrize("l,cin,cout,k,stride,pad,pool,mode", CONV,
                         ids=["-".join(map(str, c)) for c in CONV])
def test_conv1d_plain_matches_oracle(l, cin, cout, k, stride, pad, pool,
                                     mode):
    x, w, thr, flip = (_T(a) for a in _conv_case(l, cin, cout, k, 11))
    cw = port_ops.conv_weights(w)
    l_out = port_ref.conv1d_out_len(l, k, stride, pad)
    got = bk.conv1d_plain(port_ops.pack_activations(x.to(torch.int32)),
                          cw.wp, cw.wn, thr, flip.to(torch.int32), k=k,
                          stride=stride, pad=pad, l_out=l_out, pool=pool,
                          mode=mode)
    if mode == "raw":
        want = port_ref.ref_bnn_conv1d(x, w, stride, pad)
    else:
        want = port_ref.ref_bnn_conv1d_sa(x, w, thr, flip, stride, pad,
                                          pool).view(torch.int32)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Device rule
# ---------------------------------------------------------------------------

def _library_calls(to):
    """One call of each public entry point on operands made by ``to``."""
    x, w, thr, flip = _dense(4, 64, 8, 12)
    xc, wc, tc, fc = _conv_case(20, 8, 6, 3, 13)
    codes = np.random.default_rng(14).integers(0, 256, (40, 1))
    wb = np.random.default_rng(15).integers(-1, 2, (5, 1, 4))
    return {
        "twm_linear": lambda **kw: port_ops.twm_linear(
            to(x), to(w), to(thr), to(flip), **kw),
        "twm_linear_mxu": lambda **kw: port_ops.twm_linear_mxu(
            to(x), to(w), to(thr), to(flip), **kw),
        "bnn_conv1d": lambda **kw: port_ops.bnn_conv1d(
            to(xc), to(wc), to(tc), to(fc), pool=2, **kw),
        "bitserial_conv1d": lambda **kw: port_ops.bitserial_conv1d(
            to(codes), to(wb), 8, 128, stride=2, pad=2, **kw),
        "bnn_conv1d_batched": lambda **kw: port_ops.bnn_conv1d_batched(
            to(xc[None]), to(wc), mode="raw", **kw),
        "bitserial_conv1d_batched":
            lambda **kw: port_ops.bitserial_conv1d_batched(
                to(codes[None]), to(wb), bits=8, offset=128, **kw),
        "classifier_tail": lambda **kw: port_ops.classifier_tail(
            to(codes[:3]), [to(wb[0])], [None], [None],
            out_raw=(True,), **kw),
    }


ENTRY_POINTS = list(_library_calls(_T))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_numpy_input_goes_to_the_card(name, monkeypatch):
    """A numpy call runs on the card, so without one it raises instead of
    running on the CPU; CPU tensors, or ``device="cpu"``, ask for the
    plain version and give the same CPU result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _library_calls(np.asarray)[name]()
    on_cpu = _library_calls(_T)[name]()
    asked = _library_calls(np.asarray)[name](device="cpu")
    assert on_cpu.device.type == asked.device.type == "cpu"
    assert torch.equal(on_cpu, asked)


# ---------------------------------------------------------------------------
# One utterance through the library against the reference executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    prog = compiler.compile_model(spec, weights, thresholds)
    return spec, weights, thresholds, prog


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_utterance_matches_reference_executor(smoke_model, seed):
    """``offline_logits`` at the smoke width (16, in_len 800): l0 one B.3
    launch, b1-b3 one B.6 launch each (sa, pool 2), fc1's eight bit planes
    one B.7 launch, fc2 one B.7 launch -- bit-equal to the executor."""
    spec, weights, thresholds, prog = smoke_model
    x = np.random.default_rng(seed).integers(0, 256, spec.in_len).astype(
        np.uint8)
    want = executor.Executor(prog).run(x[:, None]).output.ravel()
    with dispatch.counting() as launched:
        got = port_kws.offline_logits(cases.port_spec(spec), weights,
                                      thresholds, _T(x))
    assert launched() == {bk.BITSERIAL_KERNEL: 1, bk.CONV_KERNEL: 3,
                          tm.POPCOUNT_KERNEL: 2}
    assert got.dtype == torch.int32 and got.shape == (ref_kws.N_CLASSES,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the model may also come as tensors already on the device
    w_t = {li: _T(w) for li, w in weights.items()}
    t_t = {li: tuple(map(_T, tf)) for li, tf in thresholds.items()}
    assert torch.equal(port_kws.offline_logits(cases.port_spec(spec), w_t,
                                               t_t, _T(x)), got)
    # or laid out once, with the same launches and logits
    model = port_kws.prepare_offline(cases.port_spec(spec), weights,
                                     thresholds, device="cpu")
    with dispatch.counting() as launched:
        prepared = port_kws.offline_logits(model, _T(x))
    assert launched() == {bk.BITSERIAL_KERNEL: 1, bk.CONV_KERNEL: 3,
                          tm.POPCOUNT_KERNEL: 2}
    assert prepared.dtype == torch.int32
    np.testing.assert_array_equal(prepared.numpy(), want)


def test_prepared_model_lays_out_once(smoke_model, monkeypatch):
    """``prepare_offline`` packs and lays out every layer's weights once;
    an utterance through the prepared model packs none of them again."""
    spec, weights, thresholds, _ = smoke_model
    model = port_kws.prepare_offline(cases.port_spec(spec), weights,
                                     thresholds, device="cpu")
    calls = []

    def counting(fn):
        def wrapped(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(bk, "prepare_step_weights",
                        counting(bk.prepare_step_weights))
    monkeypatch.setattr(port_ops, "pack_weight_planes",
                        counting(port_ops.pack_weight_planes))
    x = np.random.default_rng(9).integers(0, 256, spec.in_len)
    for _ in range(2):
        port_kws.offline_logits(model, _T(x))
    assert calls == []
    with pytest.raises(ValueError, match="lies on"):
        port_kws.offline_logits(model, _T(x), device="meta")
