"""Card tests of the port (marker ``gpu``): the CUDA hop kernel and the
per-stage kernels (B.3 bit-serial step, B.4 conv step raw and ``sa``,
B.5 classifier tail) against their plain PyTorch versions on the card,
bit for bit, and the megakernel and per-stage schedulers against the
dense backend on the card.  They skip without a
CUDA device.  This file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
from repro_torch.kernels import bnn_conv1d as bk
from repro_torch.kernels import dispatch
from repro_torch.kernels import hop_megakernel as mk
from repro_torch.kernels import ops
from repro_torch.models import kws
from repro_torch.stream import StreamScheduler
from repro_torch.stream.state import plan_stream

pytestmark = pytest.mark.gpu

# a geometry with a zero-width tail (k < stride), pool 4 and a pool phase
ODD = CNN1DSpec(
    in_len=2000, in_channels=1, in_bits=4, name="odd",
    layers=(
        Conv1DSpec(1, 8, k=7, stride=8, pad=0, in_bits=4, in_offset=8,
                   name="l0"),
        Conv1DSpec(8, 12, k=5, pad=2, pool=4, name="b1"),
        Conv1DSpec(12, 40, k=3, pad=1, pool=2, name="b2"),
        GAPSpec(40, name="gap"),
        FCSpec(40, 16, in_bits=8, name="fc1"),
        FCSpec(16, 12, out_raw=True, name="fc2"),
    ),
)


def _multibit_smoke():
    """The smoke spec with conv stage 1 taking an 8-bit offset-binary
    input: the hop kernel codes it from its int8 window."""
    spec = kws.build_kws_smoke_spec()
    layers = list(spec.layers)
    layers[1] = dataclasses.replace(layers[1], in_bits=8, in_offset=128)
    return dataclasses.replace(spec, layers=tuple(layers), name="multibit")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _model(spec, seed):
    """Random ternary weights; integer thresholds near the middle of each
    layer's accumulator range (a few at ±inf); random flips."""
    rng = np.random.default_rng(seed)
    weights, thresholds = {}, {}
    for li, lay in enumerate(spec.layers):
        if isinstance(lay, GAPSpec):
            continue
        k = lay.k if isinstance(lay, Conv1DSpec) else 1
        w = rng.choice(np.array([-1, 0, 1], np.int8), (k * lay.cin, lay.cout))
        if isinstance(lay, Conv1DSpec) and lay.in_bits > 1:
            mid = ((1 << lay.in_bits) - 1) / 2 - lay.in_offset
        elif isinstance(lay, FCSpec):
            mid = 127.5
        else:
            mid = 0.5
        thr = np.round(mid * w.sum(0) + rng.integers(-3, 4, lay.cout))
        thr[rng.random(lay.cout) < 0.03] = np.inf
        weights[li] = w
        thresholds[li] = (thr.astype(np.float64),
                          rng.random(lay.cout) < 0.25)
    return weights, thresholds


def _params(plan, weights, thresholds, device):
    put = lambda x, dt: torch.as_tensor(np.asarray(x)).to(device, dt)  # noqa: E731,E501
    st, fc = plan.convs, plan.fcs
    return dict(
        ws=[put(weights[s.layer_idx].reshape(s.k, s.cin, s.cout),
                torch.int8) for s in st],
        thrs=[put(thresholds[s.layer_idx][0], torch.float32) for s in st],
        flips=[put(thresholds[s.layer_idx][1], torch.int32) for s in st],
        fc_ws=[put(weights[f.layer_idx], torch.int8) for f in fc],
        fc_thrs=[put(thresholds[f.layer_idx][0], torch.float32) for f in fc],
        fc_flips=[put(thresholds[f.layer_idx][1], torch.int32) for f in fc],
    )


def _state(plan, b, seed, device):
    rng = np.random.default_rng(seed)
    put = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    st = plan.convs
    mask = (rng.random(b) < 0.75).astype(np.int32)
    return dict(
        audio=put(rng.integers(0, 256, (b, plan.hop_samples, st[0].cin),
                               dtype=np.int32)),
        mask=put(mask),
        tails=[put(rng.integers(0, 256 if s.in_bits > 1 else 2,
                                (b, s.tail, s.cin), dtype=np.int32))
               for s in st],
        pendings=[put(rng.integers(0, 2, (b, s.phase, s.cout),
                                   dtype=np.int32)) for s in st],
        gap=put(rng.integers(0, 256, (b, plan.gap_channels),
                             dtype=np.int32)),
    )


def _run(plan, p, s, device, emit, model_idx):
    T = lambda x: x.to(device)  # noqa: E731
    L = lambda xs: [T(x) for x in xs]  # noqa: E731
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    mi = None if model_idx is None else T(model_idx)
    hop = ops.hop_megakernel(
        T(s["audio"]), T(s["mask"]), L(s["tails"]), L(s["pendings"]),
        T(s["gap"]), L(p["ws"]), L(p["thrs"]), L(p["flips"]), L(p["fc_ws"]),
        L(p["fc_thrs"]), L(p["fc_flips"]), mi, stages=plan.convs, emit=emit,
        fc_raw=fc_raw)
    fin = ops.finalize_megakernel(
        L(s["tails"]), L(s["pendings"]), T(s["gap"]), L(p["ws"]),
        L(p["thrs"]), L(p["flips"]), L(p["fc_ws"]), L(p["fc_thrs"]),
        L(p["fc_flips"]), mi, stages=plan.convs, fc_raw=fc_raw)
    flat = [*hop[0], *hop[1], *hop[2:], fin]
    return [x.cpu() for x in flat]


CASES = [("kws", 8, 64, 1), ("kws", 8, 37, 2), ("smoke", 1, 16, 1),
         ("odd", 1, 20, 1), ("odd", 2, 9, 2), ("multibit", 1, 12, 1)]


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("name,hf,b,k_models", CASES,
                         ids=[f"{c[0]}-hf{c[1]}-b{c[2]}-k{c[3]}"
                              for c in CASES])
def test_cuda_kernel_matches_plain(name, hf, b, k_models, emit):
    dev = _cuda()
    spec = {"kws": kws.build_kws_spec(), "smoke": kws.build_kws_smoke_spec(),
            "odd": ODD, "multibit": _multibit_smoke()}[name]
    plan = plan_stream(spec, hop_frames=hf)
    models = [_params(plan, *_model(spec, m), torch.device("cpu"))
              for m in range(k_models)]
    p = models[0] if k_models == 1 else {
        k: [torch.stack(xs) for xs in zip(*(m[k] for m in models))]
        for k in models[0]}
    s = _state(plan, b, seed=b, device=torch.device("cpu"))
    model_idx = (torch.as_tensor(np.random.default_rng(b).integers(
        0, k_models, b).astype(np.int32)) if k_models > 1 else None)
    plain = _run(plan, p, s, torch.device("cpu"), emit, model_idx)
    with dispatch.counting() as launched:
        card = _run(plan, p, s, dev, emit, model_idx)
    assert launched() == {mk.HOP_KERNEL: 1, mk.FINALIZE_KERNEL: 1}
    assert len(card) == len(plain)
    for x, y in zip(card, plain):
        assert x.dtype == torch.int32 and x.shape == y.shape
        assert torch.equal(x, y)


def test_cuda_wrapper_rejects_bad_operands():
    dev = _cuda()
    plan = plan_stream(kws.build_kws_smoke_spec(), hop_frames=1)
    p = _params(plan, *_model(plan.spec, 0), dev)
    s = _state(plan, 4, 0, dev)
    geoms = tuple(mk.stage_geom(st) for st in plan.convs)
    tails = tuple(t for g, t in zip(geoms, s["tails"]) if g.tail)
    pends = tuple(t for g, t in zip(geoms, s["pendings"]) if g.phase)
    args = (s["audio"], s["mask"], tails, pends, s["gap"], p["ws"], p["thrs"],
            p["flips"])
    with pytest.raises(TypeError):
        mk.hop_megakernel_packed(*args[:4], s["gap"].float(), *args[5:],
                                 geoms=geoms, emit=False)
    strided = torch.zeros((4, 2 * s["gap"].shape[1]), dtype=torch.int32,
                          device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        mk.hop_megakernel_packed(*args[:4], strided, *args[5:],
                                 geoms=geoms, emit=False)


@pytest.mark.parametrize("emit", [True, False])
def test_cuda_scheduler_matches_dense_backend(emit):
    """The megakernel scheduler against the dense backend on the card,
    hop by hop, through ragged pushes, joins, peeks and closes."""
    dev = _cuda()
    spec = kws.build_kws_smoke_spec()
    weights, thresholds = _model(spec, 1)
    rng = np.random.default_rng(2)
    clips = [rng.integers(0, 256, 3000, dtype=np.uint8) for _ in range(6)]
    runs = {}
    for backend in ("torch", "megakernel"):
        s = StreamScheduler(spec, weights, thresholds, capacity=8,
                            hop_frames=1, backend=backend, emit_logits=emit,
                            device=dev)
        rec = []
        for sid in range(6):
            s.add_stream(sid)
        cut = np.random.default_rng(3)
        pos = [0] * 6
        while any(p < 3000 for p in pos):
            sids, chunks = [], []
            for sid in range(6):
                n = int(cut.integers(1, 300))
                if pos[sid] < 3000:
                    sids.append(sid)
                    chunks.append(clips[sid][pos[sid]:pos[sid] + n])
                    pos[sid] += n
            s.push_audio_batch(sids, chunks)
            while True:
                with dispatch.counting() as launched:
                    hb = s.step_batch()
                if hb is None:
                    break
                assert launched() == ({mk.HOP_KERNEL: 1}
                                      if backend == "megakernel" else {})
                rec.append((hb.sids, hb.frames, hb.logits))
            rec.append(s.peek(0))
        rec += [s.close_stream(sid).logits for sid in range(6)]
        runs[backend] = rec
    assert len(runs["torch"]) == len(runs["megakernel"])
    for a, b in zip(runs["torch"], runs["megakernel"]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if x is None:
                assert y is None
            else:
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Per-stage kernels (B.3-B.5)
# ---------------------------------------------------------------------------

def _per_stage_calls(b, seed, k_models):
    """One call of each per-stage entry point at the KWS plan's shapes
    (hop_frames=8) on seeded inputs, as (kernel name, fn(device))."""
    plan = plan_stream(kws.build_kws_spec(), hop_frames=8)
    rng = np.random.default_rng(seed)
    lead = () if k_models == 1 else (k_models,)
    mi = (torch.as_tensor(rng.integers(0, k_models, b).astype(np.int32))
          if k_models > 1 else None)
    calls = []
    for st in plan.convs:
        w = torch.as_tensor(rng.integers(-1, 2, lead + (st.k, st.cin,
                                                          st.cout)))
        length = st.tail + st.n_in
        if st.in_bits > 1:
            x = torch.as_tensor(rng.integers(0, 256, (b, length, st.cin)))
            calls.append((bk.BITSERIAL_KERNEL, lambda d, x=x, w=w, st=st:
                          ops.bitserial_conv1d_batched(
                              x.to(d), w.to(d), None if mi is None
                              else mi.to(d), bits=st.in_bits,
                              offset=st.in_offset, stride=st.stride)))
            continue
        x = torch.as_tensor(rng.integers(0, 2, (b, length, st.cin)))
        calls.append((bk.CONV_STEP_KERNEL, lambda d, x=x, w=w, st=st:
                      ops.bnn_conv1d_batched(
                          x.to(d), w.to(d), None, None,
                          None if mi is None else mi.to(d),
                          stride=st.stride, mode="raw")))
        if k_models == 1:
            thr = torch.as_tensor(np.round(rng.normal(
                0, 4, st.cout)).astype(np.float32))
            thr[:3] = torch.tensor([np.inf, -np.inf, np.inf])
            flip = torch.as_tensor((rng.random(st.cout) < 0.3).astype(
                np.int32))
            for pool in (1, 2):
                calls.append((bk.CONV_STEP_KERNEL,
                              lambda d, x=x, w=w, st=st, t=thr, f=flip,
                              pool=pool: ops.bnn_conv1d_batched(
                                  x.to(d), w.to(d), t.to(d), f.to(d),
                                  stride=st.stride, pool=pool, mode="sa")))
    fc_ws = [torch.as_tensor(rng.integers(-1, 2, lead + (f.cin, f.cout)))
             for f in plan.fcs]
    fc_thrs = [torch.as_tensor(np.round(rng.normal(
        0, 40, lead + (f.cout,))).astype(np.float32)) for f in plan.fcs]
    fc_flips = [torch.as_tensor((rng.random(lead + (f.cout,)) < 0.3).astype(
        np.int32)) for f in plan.fcs]
    gap = torch.as_tensor(rng.integers(0, 300, (b, plan.gap_channels)))
    out_raw = tuple(f.out_raw for f in plan.fcs)
    calls.append((bk.TAIL_KERNEL, lambda d: ops.classifier_tail(
        gap.to(d), [w.to(d) for w in fc_ws], [t.to(d) for t in fc_thrs],
        [f.to(d) for f in fc_flips], None if mi is None else mi.to(d),
        out_raw=out_raw)))
    return calls


@pytest.mark.parametrize("b,k_models", [(64, 1), (37, 1), (21, 2)],
                         ids=["b64", "b37", "b21-k2"])
def test_cuda_per_stage_kernels_match_plain(b, k_models):
    dev = _cuda()
    for name, fn in _per_stage_calls(b, b, k_models):
        want = fn(torch.device("cpu"))
        with dispatch.counting() as launched:
            got = fn(dev)
        torch.cuda.synchronize()
        assert launched() == {name: 1}
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want), name


def test_cuda_per_stage_scheduler_matches_dense_backend():
    """The per-stage scheduler against the dense backend on the card, hop
    by hop, with every hop's launches equal to ``dispatches_per_hop`` and
    a hop-boundary peek's to ``dispatches_per_finalize``."""
    dev = _cuda()
    spec = kws.build_kws_spec()
    weights, thresholds = _model(spec, 4)
    rng = np.random.default_rng(5)
    clips = [rng.integers(0, 256, 6000, dtype=np.uint8) for _ in range(5)]
    runs = {}
    for backend in ("torch", "per_stage"):
        for emit in (True, False):
            s = StreamScheduler(spec, weights, thresholds, capacity=8,
                                hop_frames=8, backend=backend,
                                emit_logits=emit, device=dev)
            rec = []
            for sid in range(5):
                s.add_stream(sid)
            s.push_audio_batch(list(range(5)), [c[:4700] for c in clips])
            while True:
                with dispatch.counting() as launched:
                    hb = s.step_batch()
                if hb is None:
                    break
                assert sum(launched().values()) == \
                    s._model.dispatches_per_hop(emit)
                rec.append((hb.sids, hb.frames, hb.logits))
            # stream 0 onto a hop boundary, then a peek
            left = len(s._streams[0].frontend)
            s.push_audio(0, np.full(s.plan.hop_samples - left, 128,
                                    np.uint8))
            s.drain()
            with dispatch.counting() as launched:
                rec.append(s.peek(0))
            assert sum(launched().values()) == (
                0 if emit else s._model.dispatches_per_finalize())
            s.push_audio_batch(list(range(5)), [c[4700:] for c in clips])
            s.drain()
            rec += [s.close_stream(sid).logits for sid in range(5)]
            runs[backend, emit] = rec
    for emit in (True, False):
        a_run, b_run = runs["torch", emit], runs["per_stage", emit]
        assert len(a_run) == len(b_run)
        for a, b in zip(a_run, b_run):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_array_equal(x, y)
