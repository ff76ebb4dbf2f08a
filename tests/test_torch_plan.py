"""Port parity, plan side: ``repro_torch``'s spec builders, ``plan_stream``
and ``prepared_model_params`` against the reference's, on the smoke spec,
the full-width KWS spec at hop_frames 1 and 8, and seeded random
streamable geometries."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro.stream import scheduler as ref_sched
from repro.stream.state import plan_stream as ref_plan_stream
from repro_torch.kernels import hop_megakernel as mk
from repro_torch.models import kws as port_kws
from repro_torch.stream import scheduler as port_sched
from repro_torch.stream.state import plan_stream as port_plan_stream


def _cases():
    out = [("smoke", ref_kws.build_kws_smoke_spec(), 1),
           ("kws-hf1", ref_kws.build_kws_spec(), 1),
           ("kws-hf8", ref_kws.build_kws_spec(), 8)]
    for seed in cases.RANDOM_SEEDS:
        built = cases.random_spec(seed)
        assert built is not None, f"seed {seed} has no steady geometry"
        out.append((f"rand{seed}", *built))
    return out


CASES = _cases()


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name != "spec"}


@pytest.mark.parametrize("spec_fn", ["build_kws_spec",
                                     "build_kws_smoke_spec"])
def test_kws_spec_builders_match(spec_fn):
    ref = getattr(ref_kws, spec_fn)()
    assert getattr(port_kws, spec_fn)() == cases.port_spec(ref)
    assert (port_kws.N_CLASSES, port_kws.IN_LEN, port_kws.IN_OFFSET) == (
        ref_kws.N_CLASSES, ref_kws.IN_LEN, ref_kws.IN_OFFSET)


@pytest.mark.parametrize("name,spec,hf", CASES, ids=[c[0] for c in CASES])
def test_plan_stream_fields_match(name, spec, hf):
    ref = ref_plan_stream(spec, hop_frames=hf)
    port = port_plan_stream(cases.port_spec(spec), hop_frames=hf)
    top = _fields(ref)
    top.pop("convs"), top.pop("fcs")
    ptop = _fields(port)
    ptop.pop("convs"), ptop.pop("fcs")
    assert ptop == top
    assert [_fields(s) for s in port.convs] == [_fields(s) for s in ref.convs]
    assert [_fields(s) for s in port.fcs] == [_fields(s) for s in ref.fcs]
    assert port.frames_per_hop == ref.frames_per_hop
    assert port.macs_per_hop() == ref.macs_per_hop()
    assert port.fc_macs() == ref.fc_macs()


@pytest.mark.parametrize("name,spec,hf", CASES, ids=[c[0] for c in CASES])
def test_prepared_model_params_match(name, spec, hf):
    weights, thresholds = cases.exported(spec, seed=3)
    ref = ref_sched.prepared_model_params(
        ref_plan_stream(spec, hop_frames=hf), weights, thresholds)
    port = port_sched.prepared_model_params(
        port_plan_stream(cases.port_spec(spec), hop_frames=hf), weights,
        thresholds, device="cpu")
    for key in ("w", "thr", "flip", "fc_w", "fc_thr", "fc_flip"):
        assert len(port[key]) == len(ref[key]), key
        for a, b in zip(ref[key], port[key]):
            a = np.asarray(a)
            assert b.device.type == "cpu"
            assert b.numpy().dtype == a.dtype, key
            np.testing.assert_array_equal(b.numpy(), a, err_msg=key)
    # a == 0 channels keep their infinite thresholds through the prep
    thr = np.concatenate([t.numpy() for t in port["thr"]])
    ref_thr = np.concatenate([np.asarray(t) for t in ref["thr"]])
    assert np.array_equal(np.isinf(thr), np.isinf(ref_thr))


def test_prepared_model_params_memoized():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    plan = port_plan_stream(cases.port_spec(spec))
    first = port_sched.prepared_model_params(plan, weights, thresholds,
                                             device="cpu")
    hits = port_sched.param_cache_stats()["hits"]
    again = port_sched.prepared_model_params(plan, weights, thresholds,
                                             device="cpu")
    assert again is first
    assert port_sched.param_cache_stats()["hits"] == hits + 1


@pytest.mark.parametrize("name,spec,hf", CASES, ids=[c[0] for c in CASES])
def test_kernel_shared_memory_fits(name, spec, hf):
    """Every plan the tests drive fits one CTA's shared memory; the full
    KWS plan at hop_frames=8 stays under the 48 KB default window."""
    plan = port_plan_stream(cases.port_spec(spec), hop_frames=hf)
    geoms = tuple(mk.stage_geom(st) for st in plan.convs)
    fc = [(f.cin, f.cout) for f in plan.fcs]
    win0, bin_, frm, fce, total = mk.smem_layout(geoms, fc,
                                                 plan.gap_channels)
    assert total <= mk.MAX_SMEM
    g0 = geoms[0]
    assert win0 >= g0.cin * (g0.tail + g0.n_in)
    for g in geoms[1:]:
        assert bin_ >= (g.tail + g.n_in) * g.cin
        assert bin_ >= (g.tail + g.flush_in + g.pad) * g.cin
    assert frm >= max((g.phase + g.n_conv) * g.cout for g in geoms)
    if name == "kws-hf8":
        assert total <= 48 * 1024


def test_stage_geom_copies_plan_fields():
    plan = port_plan_stream(port_kws.build_kws_spec(), hop_frames=8)
    for st in plan.convs:
        g = mk.stage_geom(st)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(st, f.name)


def test_prepared_params_default_device_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    spec = port_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(ref_kws.build_kws_smoke_spec())
    if torch.cuda.is_available():
        prep = port_sched.prepared_model_params(
            port_plan_stream(spec), weights, thresholds)
        assert prep["w"][0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            port_sched.prepared_model_params(
                port_plan_stream(spec), weights, thresholds)
