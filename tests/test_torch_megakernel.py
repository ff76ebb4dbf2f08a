"""Port parity, kernel side: the plain PyTorch version of the hop
megakernel (``repro_torch.kernels.ops.hop_megakernel`` /
``finalize_megakernel`` on CPU tensors) against the reference's Pallas
megakernel in interpret mode, bit for bit in int32 — the smoke plan and
random geometries, emit and steady hops, masked rows, a batch that is not
a multiple of the reference's slot block, and a K=2 tenant pool.  The
CUDA kernel is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.kernels import ops as ref_ops
from repro.models import kws as ref_kws
from repro.stream.state import plan_stream as ref_plan_stream
from repro_torch.kernels import dispatch
from repro_torch.kernels import hop_megakernel as mk
from repro_torch.kernels import ops as port_ops
from repro_torch.stream.state import plan_stream as port_plan_stream


def _stack(models, key):
    return [np.stack(xs) for xs in zip(*(m[key] for m in models))]


def _operands(spec, hf, b, seed, k_models=1):
    """Seeded inputs for one hop: audio codes, a mask with zeros, binary
    state for the binary stages, raw codes in layer 0's tail, GAP counts,
    and the model params (stacked over a leading pool axis when
    ``k_models > 1``)."""
    plan = ref_plan_stream(spec, hop_frames=hf)
    rng = np.random.default_rng(seed)
    st = plan.convs
    models = []
    for m in range(k_models):
        w, t = cases.exported(spec, seed=m)
        models.append({
            "ws": [w[s.layer_idx].reshape(s.k, s.cin, s.cout).astype(np.int32)
                   for s in st],
            "thrs": [t[s.layer_idx][0].astype(np.float32) for s in st],
            "flips": [t[s.layer_idx][1].astype(np.int32) for s in st],
            "fc_ws": [w[f.layer_idx].astype(np.int32) for f in plan.fcs],
            "fc_thrs": [t[f.layer_idx][0].astype(np.float32)
                        for f in plan.fcs],
            "fc_flips": [t[f.layer_idx][1].astype(np.int32)
                         for f in plan.fcs],
        })
    keys = ("ws", "thrs", "flips", "fc_ws", "fc_thrs", "fc_flips")
    params = ({k: models[0][k] for k in keys} if k_models == 1
              else {k: _stack(models, k) for k in keys})
    ops = {
        "audio": rng.integers(0, 256, (b, plan.hop_samples, st[0].cin),
                              dtype=np.int32),
        "mask": (rng.random(b) < 0.7).astype(np.int32),
        "tails": [rng.integers(0, 256 if i == 0 else 2, (b, s.tail, s.cin),
                               dtype=np.int32) for i, s in enumerate(st)],
        "pendings": [rng.integers(0, 2, (b, s.phase, s.cout),
                                  dtype=np.int32) for s in st],
        "gap": rng.integers(0, 256, (b, plan.gap_channels), dtype=np.int32),
    }
    ops["mask"][0] = 0
    ops["mask"][-1] = 1
    return plan, ops, params


def _ref_hop(plan, o, p, emit, model_idx, bb):
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    return ref_ops.hop_megakernel(
        jnp.asarray(o["audio"]), jnp.asarray(o["mask"]), J(o["tails"]),
        J(o["pendings"]), jnp.asarray(o["gap"]), J(p["ws"]), p["thrs"],
        p["flips"], J(p["fc_ws"]), p["fc_thrs"], p["fc_flips"],
        None if model_idx is None else jnp.asarray(model_idx),
        stages=plan.convs, emit=emit,
        fc_raw=tuple(f.out_raw for f in plan.fcs), bb=bb, interpret=True)


def _ref_finalize(plan, o, p, model_idx, bb):
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    return ref_ops.finalize_megakernel(
        J(o["tails"]), J(o["pendings"]), jnp.asarray(o["gap"]), J(p["ws"]),
        p["thrs"], p["flips"], J(p["fc_ws"]), p["fc_thrs"], p["fc_flips"],
        None if model_idx is None else jnp.asarray(model_idx),
        stages=plan.convs, fc_raw=tuple(f.out_raw for f in plan.fcs), bb=bb,
        interpret=True)


def _port_args(o, p, device="cpu"):
    T = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    L = lambda xs: [T(x) for x in xs]  # noqa: E731
    return dict(
        tails=L(o["tails"]), pendings=L(o["pendings"]), gap=T(o["gap"]),
        ws=L(p["ws"]), thrs=L(p["thrs"]), flips=L(p["flips"]),
        fc_ws=L(p["fc_ws"]), fc_thrs=L(p["fc_thrs"]),
        fc_flips=L(p["fc_flips"]),
    ), T


def _port_hop(plan, o, p, emit, model_idx, bb, device="cpu"):
    kw, T = _port_args(o, p, device)
    return port_ops.hop_megakernel(
        T(o["audio"]), T(o["mask"]), kw["tails"], kw["pendings"], kw["gap"],
        kw["ws"], kw["thrs"], kw["flips"], kw["fc_ws"], kw["fc_thrs"],
        kw["fc_flips"], None if model_idx is None else T(model_idx),
        stages=plan.convs, emit=emit,
        fc_raw=tuple(f.out_raw for f in plan.fcs), bb=bb)


def _port_finalize(plan, o, p, model_idx, bb, device="cpu"):
    kw, T = _port_args(o, p, device)
    return port_ops.finalize_megakernel(
        kw["tails"], kw["pendings"], kw["gap"], kw["ws"], kw["thrs"],
        kw["flips"], kw["fc_ws"], kw["fc_thrs"], kw["fc_flips"],
        None if model_idx is None else T(model_idx),
        stages=plan.convs, fc_raw=tuple(f.out_raw for f in plan.fcs), bb=bb)


def _assert_hop_equal(ref, port, emit):
    assert len(port) == (4 if emit else 3)
    for a, b in zip(ref[0], port[0]):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a))
    for a, b in zip(ref[1], port[1]):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a))
    np.testing.assert_array_equal(port[2].cpu().numpy(), np.asarray(ref[2]))
    if emit:
        assert port[3].dtype == torch.int32
        np.testing.assert_array_equal(port[3].cpu().numpy(),
                                      np.asarray(ref[3]))


def _spec(name):
    if name == "smoke":
        return ref_kws.build_kws_smoke_spec(), None
    spec, hf = cases.random_spec(int(name[4:]))
    return spec, hf


# (spec, hop_frames, B, emit, tenant models, reference slot block)
HOP_CASES = [
    ("smoke", 1, 6, True, 1, 4),     # masked rows; 6 pads to 8 at bb=4
    ("smoke", 4, 5, False, 1, None),
    ("rand0", None, 4, True, 1, None),
    ("rand1", None, 3, False, 1, None),
    ("rand2", None, 5, True, 1, 2),
    ("smoke", 1, 8, True, 2, 4),     # pooled K=2, per-block model rows
]


@pytest.mark.parametrize(
    "name,hf,b,emit,k_models,bb", HOP_CASES,
    ids=[f"{c[0]}-hf{c[1]}-b{c[2]}-{'emit' if c[3] else 'steady'}-k{c[4]}"
         for c in HOP_CASES])
def test_plain_hop_matches_reference(name, hf, b, emit, k_models, bb):
    spec, rhf = _spec(name)
    hf = hf or rhf
    plan, o, p = _operands(spec, hf, b, seed=b + hf, k_models=k_models)
    # block-uniform pool rows would hide the per-block rule: mix them
    model_idx = (np.array([1, 0, 1, 1, 0, 1, 0, 0], np.int32)[:b]
                 if k_models > 1 else None)
    ref = _ref_hop(plan, o, p, emit, model_idx, bb)
    pplan = port_plan_stream(cases.port_spec(spec), hop_frames=hf)
    with dispatch.counting() as launched:
        port = _port_hop(pplan, o, p, emit, model_idx, bb)
    assert launched() == {mk.HOP_KERNEL: 1}
    _assert_hop_equal(ref, port, emit)


FIN_CASES = [("smoke", 1, 6, 1, 4), ("rand0", None, 3, 1, None),
             ("smoke", 1, 8, 2, 4)]


@pytest.mark.parametrize("name,hf,b,k_models,bb", FIN_CASES,
                         ids=[f"{c[0]}-b{c[2]}-k{c[3]}" for c in FIN_CASES])
def test_plain_finalize_matches_reference(name, hf, b, k_models, bb):
    spec, rhf = _spec(name)
    hf = hf or rhf
    plan, o, p = _operands(spec, hf, b, seed=11 * b, k_models=k_models)
    model_idx = (np.array([0, 0, 1, 0, 1, 1, 1, 0], np.int32)[:b]
                 if k_models > 1 else None)
    ref = _ref_finalize(plan, o, p, model_idx, bb)
    pplan = port_plan_stream(cases.port_spec(spec), hop_frames=hf)
    with dispatch.counting() as launched:
        port = _port_finalize(pplan, o, p, model_idx, bb)
    assert launched() == {mk.FINALIZE_KERNEL: 1}
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_zero_width_state_passes_through():
    """Stages with ``tail == 0`` / ``phase == 0`` keep their (B, 0, C)
    entries: the wrapper filters them out of the kernel and puts the same
    objects back."""
    spec = ref_kws.build_kws_smoke_spec()
    plan, o, p = _operands(spec, 1, 3, seed=5)
    pplan = port_plan_stream(cases.port_spec(spec), hop_frames=1)
    kw, T = _port_args(o, p)
    out = port_ops.hop_megakernel(
        T(o["audio"]), T(o["mask"]), kw["tails"], kw["pendings"], kw["gap"],
        kw["ws"], kw["thrs"], kw["flips"], stages=pplan.convs, emit=False)
    zero = [i for i, st in enumerate(pplan.convs) if not st.phase]
    assert zero, "smoke plan has zero-phase stages"
    for i in zero:
        assert out[1][i] is kw["pendings"][i]


def test_non_cuda_device_raises_instead_of_falling_back():
    """Only CPU tensors take the plain version; any other device goes to
    the CUDA kernel, which refuses what it cannot launch."""
    spec = ref_kws.build_kws_smoke_spec()
    plan, o, p = _operands(spec, 1, 2, seed=1)
    pplan = port_plan_stream(cases.port_spec(spec), hop_frames=1)
    with pytest.raises(ValueError, match="CUDA"):
        _port_hop(pplan, o, p, True, None, None, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        _port_finalize(pplan, o, p, None, None, device="meta")


def _multibit_later_stage_spec():
    """The smoke spec with conv stage 1 taking an 8-bit offset-binary
    input (``in_bits=8, in_offset=128``) instead of binary maps."""
    spec = ref_kws.build_kws_smoke_spec()
    layers = list(spec.layers)
    conv = [i for i, lay in enumerate(layers) if hasattr(lay, "k")]
    layers[conv[1]] = dataclasses.replace(layers[conv[1]], in_bits=8,
                                          in_offset=128)
    return dataclasses.replace(spec, layers=tuple(layers),
                               name="smoke-multibit-b1")


@pytest.mark.parametrize("emit", [True, False])
def test_plain_hop_matches_reference_multibit_later_stage(emit):
    """A bit-serial input past the first conv stage: the plain hop and
    finalize against the reference's megakernel, with raw 8-bit codes in
    that stage's carried tail (as its offset pad leaves there)."""
    spec = _multibit_later_stage_spec()
    plan, o, p = _operands(spec, 1, 6, seed=21 + emit)
    assert plan.convs[1].in_bits == 8 and plan.convs[1].tail
    o["tails"][1] = np.random.default_rng(3).integers(
        0, 256, o["tails"][1].shape, dtype=np.int32)
    pplan = port_plan_stream(cases.port_spec(spec), hop_frames=1)
    ref = _ref_hop(plan, o, p, emit, None, 4)
    _assert_hop_equal(ref, _port_hop(pplan, o, p, emit, None, 4), emit)
    np.testing.assert_array_equal(
        _port_finalize(pplan, o, p, None, 4).numpy(),
        np.asarray(_ref_finalize(plan, o, p, None, 4)))


def test_cuda_wrapper_refuses_multibit_later_stage():
    """The CUDA kernel keeps the windows of later stages as int8, which
    holds the code of an input of at most 8 bits: a wider bit-serial
    input past the first stage is refused, not miscomputed."""
    pplan = port_plan_stream(
        cases.port_spec(ref_kws.build_kws_smoke_spec()), hop_frames=1)
    geoms = [mk.stage_geom(s) for s in pplan.convs]
    geoms[1] = dataclasses.replace(geoms[1], in_bits=9, in_offset=256)
    gap = torch.zeros((2, pplan.gap_channels), dtype=torch.int32,
                      device="meta")
    with pytest.raises(ValueError, match="in_bits <= 8"):
        mk.hop_megakernel_packed(None, None, (), (), gap, (), (), (),
                                 geoms=tuple(geoms), emit=False)
