"""Card tests of the port (marker ``gpu``): the CUDA hop kernel, the
per-stage kernels (B.3 bit-serial step, B.4 conv step raw and ``sa`` at
ragged edges and every tile, B.5 classifier tail with tenants at every
slot block and cluster size) and the kernel library's (B.6 fused conv -> SA ->
pool, B.7 popcount GEMM raw and ``sa``, B.8 int8 tensor-core GEMM)
against their plain PyTorch versions on the card, bit for bit, and the
megakernel and per-stage schedulers against the dense backend on the
card, the KWS training step (the QAT forward, a train step, the trained
model's deploy) on the card against the CPU, the async scheduler against the synchronous one (its dispatch
stage under sync debug mode ``"error"``), donated state buffers, a
tenant pool's row reused after an eviction, the slot pool over S
shards of the card against one shard, and the chip twin's executor on the
card against its CPU run.  They skip without a CUDA device.  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
from repro_torch.kernels import conv_kernels as bk
from repro_torch.kernels import dispatch
from repro_torch.kernels import hop_megakernel as mk
from repro_torch.kernels import ops
from repro_torch.models import kws
from repro_torch.stream import AsyncStreamScheduler, StreamScheduler
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


# B=1, 200 and 257 leave ragged slot blocks; with K=2 the pool row is
# random per slot, so slot blocks mix tenants
CASES = [("kws", 8, 64, 1), ("kws", 8, 37, 2), ("smoke", 1, 16, 1),
         ("odd", 1, 20, 1), ("odd", 2, 9, 2), ("multibit", 1, 12, 1),
         ("kws", 8, 1, 1), ("kws", 8, 200, 1), ("kws", 8, 257, 2)]


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("name,hf,b,k_models", CASES,
                         ids=[f"{c[0]}-hf{c[1]}-b{c[2]}-k{c[3]}"
                              for c in CASES])
def test_cuda_kernel_matches_plain(name, hf, b, k_models, emit):
    dev = _cuda()
    spec = _spec(name)
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


def _spec(name):
    return {"kws": kws.build_kws_spec(), "smoke": kws.build_kws_smoke_spec(),
            "odd": ODD, "multibit": _multibit_smoke()}[name]


def _packed_case(name, hf, b, seed, device):
    """Packed operands of one hop (the kernel's wrapper's own layout)."""
    plan = plan_stream(_spec(name), hop_frames=hf)
    p = _params(plan, *_model(plan.spec, seed), device)
    s = _state(plan, b, seed, device)
    geoms = tuple(mk.stage_geom(st) for st in plan.convs)
    s["tails"] = tuple(t for g, t in zip(geoms, s["tails"]) if g.tail)
    s["pendings"] = tuple(t for g, t in zip(geoms, s["pendings"])
                          if g.phase)
    return plan, geoms, p, s


def _hop_three_ways(plan, geoms, p, s, model_idx=None, slots=None):
    """B.1 emit, B.1 steady and B.2, kernel against plain: the kernel by
    the counted entry points, or at a forced slot block."""
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    w = (p["ws"], p["thrs"], p["flips"], p["fc_ws"], p["fc_thrs"],
         p["fc_flips"], model_idx)
    for emit in (True, False):
        args = (s["audio"], s["mask"], s["tails"], s["pendings"], s["gap"],
                *w)
        if slots is None:
            got = mk.hop_megakernel_packed(*args, geoms=geoms, emit=emit,
                                           fc_raw=fc_raw)
        else:
            got = mk._launch(*args, geoms=geoms, emit=emit, fc_raw=fc_raw,
                             finalize_only=False, slots=slots)
        want = mk.hop_megakernel_plain(*args, geoms=geoms, emit=emit,
                                       fc_raw=fc_raw)
        flat = lambda o: [*o[0], *o[1], *o[2:]]  # noqa: E731
        for x, y in zip(flat(got), flat(want)):
            assert x.dtype == torch.int32 and torch.equal(x, y)
    fargs = (s["tails"], s["pendings"], s["gap"], *w)
    if slots is None:
        got = mk.finalize_megakernel_packed(*fargs, geoms=geoms,
                                            fc_raw=fc_raw)
    else:
        got = mk._launch(None, None, *fargs, geoms=geoms, emit=True,
                         fc_raw=fc_raw, finalize_only=True, slots=slots)
    assert torch.equal(got, mk.finalize_megakernel_plain(
        *fargs, geoms=geoms, fc_raw=fc_raw))


def test_cuda_kernel_all_masked_batch():
    """No live slot: every slot's state passes through, and the emit hop's
    and the peek's logits still come from the flush of that state."""
    dev = _cuda()
    plan, geoms, p, s = _packed_case("kws", 8, 40, 3, dev)
    s["mask"] = torch.zeros_like(s["mask"])
    _hop_three_ways(plan, geoms, p, s)


@pytest.mark.parametrize("name,hf,b,slots", [
    ("kws", 8, 66, 1), ("kws", 8, 66, 2), ("kws", 8, 66, 4),
    ("smoke", 1, 61, 8), ("odd", 2, 21, 8)], ids=str)
def test_cuda_kernel_every_slot_block(name, hf, b, slots):
    """Each slot block forced once (eight slots where the plan fits them),
    with per-slot tenants, on a batch that leaves the last block ragged."""
    dev = _cuda()
    plan, geoms, p1, s = _packed_case(name, hf, b, 5, dev)
    p2 = _params(plan, *_model(plan.spec, 6), dev)
    pooled = {k: [torch.stack(xs) for xs in zip(p1[k], p2[k])] for k in p1}
    mi = torch.as_tensor(np.random.default_rng(b).integers(
        0, 2, b).astype(np.int32), device=dev)
    _hop_three_ways(plan, geoms, p1, s, slots=slots)
    _hop_three_ways(plan, geoms, pooled, s, mi, slots=slots)


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


def _strict_dispatch(sched):
    """Run the scheduler's dispatch stage under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in it (a
    pageable copy, ``.item()``, ``nonzero``) raises."""
    inner = sched._dispatch_hop

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sched._dispatch_hop = strict


def _record_hops(sched, hops):
    fold = sched._fold_hop

    def spy(*args, **kw):
        hb = fold(*args, **kw)
        hops.append(hb)
        return hb
    sched._fold_hop = spy


def _stream_run(sched, clips, seed, peek=True):
    """Ragged pushes of ``clips`` (one stream each), steps until starved
    after each round, a peek of stream 0, then every close.  Returns the
    folded hops, the peeks and the closes' logits."""
    hops = []
    _record_hops(sched, hops)
    n = len(clips)
    for sid in range(n):
        sched.add_stream(sid)
    cut = np.random.default_rng(seed)
    pos = [0] * n
    peeks = []
    while any(p < len(c) for p, c in zip(pos, clips)):
        sids, chunks = [], []
        for sid in range(n):
            k = int(cut.integers(1, 400))
            if pos[sid] < len(clips[sid]):
                sids.append(sid)
                chunks.append(clips[sid][pos[sid]:pos[sid] + k])
                pos[sid] += k
        sched.push_audio_batch(sids, chunks)
        sched.drain()
        if peek:
            peeks.append(sched.peek(0))
    closes = [sched.close_stream(sid).logits for sid in range(n)]
    if isinstance(sched, AsyncStreamScheduler):
        assert sched.in_flight == 0
        sched.shutdown(timeout=60.0)
    return hops, peeks, closes


def _same_runs(a, b):
    (ha, pa, ca), (hb, pb, cb) = a, b
    assert len(ha) == len(hb) > 0
    for x, y in zip(ha, hb):
        np.testing.assert_array_equal(x.sids, y.sids)
        np.testing.assert_array_equal(x.frames, y.frames)
        if x.logits is None:
            assert y.logits is None
        else:
            np.testing.assert_array_equal(x.logits, y.logits)
            np.testing.assert_array_equal(x.posteriors, y.posteriors)
        assert [(d.stream_id, d.cls, d.frame) for d in x.detections] == [
            (d.stream_id, d.cls, d.frame) for d in y.detections]
    for x, y in zip(pa + ca, pb + cb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend,emit", [("megakernel", True),
                                          ("megakernel", False),
                                          ("per_stage", True)])
def test_cuda_async_matches_sync(backend, emit):
    """The async scheduler (pump, depth-1 pipeline, donated state on the
    megakernel) equals the synchronous one on the card hop for hop, with
    every async dispatch run under sync debug mode ``"error"``."""
    dev = _cuda()
    spec = kws.build_kws_smoke_spec()
    weights, thresholds = _model(spec, 1)
    rng = np.random.default_rng(2)
    clips = [rng.integers(0, 256, int(rng.integers(1500, 3000)),
                          dtype=np.uint8) for _ in range(6)]
    kw = dict(capacity=8, initial_capacity=2, hop_frames=1, backend=backend,
              emit_logits=emit, device=dev)
    sync = _stream_run(StreamScheduler(spec, weights, thresholds, **kw),
                       clips, 3)
    asyn = AsyncStreamScheduler(spec, weights, thresholds, **kw)
    assert asyn._donate == (backend == "megakernel")
    _strict_dispatch(asyn)
    _same_runs(sync, _stream_run(asyn, clips, 3))


def test_cuda_donated_state_ping_pong():
    """``donate_buffers`` on the card: two state sets alternate, a steady
    hop allocates none of the state tensors the run without donation
    allocates each hop, and the two runs are equal."""
    dev = _cuda()
    spec = kws.build_kws_smoke_spec()
    weights, thresholds = _model(spec, 5)
    clips = [np.random.default_rng(6 + i).integers(0, 256, 2400,
                                                   dtype=np.uint8)
             for i in range(3)]
    runs, ptrs, allocs = [], [], []
    for donate in (True, False):
        s = StreamScheduler(spec, weights, thresholds, capacity=4,
                            initial_capacity=4, hop_frames=1, device=dev,
                            donate_buffers=donate)
        seen, per_hop = [], []
        step = s.step_batch

        def tracked():
            n0 = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
            hb = step()
            if hb is not None:
                seen.append(s._gap.data_ptr())
                per_hop.append(torch.cuda.memory_stats(dev)[
                    "allocation.all.allocated"] - n0)
            return hb
        s.step_batch = tracked
        runs.append(_stream_run(s, clips, 7, peek=False))
        ptrs.append(seen)
        allocs.append(per_hop)
    _same_runs(*runs)
    assert len(set(ptrs[0])) == 2
    assert all(a != b for a, b in zip(ptrs[0], ptrs[0][1:]))
    plan = plan_stream(spec, hop_frames=1)
    n_state = sum(1 for st in plan.convs if st.tail) + sum(
        1 for st in plan.convs if st.phase) + 1
    # the first hop of each run also makes the spare set or the staging
    steady = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]  # noqa: E731
    assert steady(allocs[1]) - steady(allocs[0]) == n_state


@pytest.mark.parametrize("backend", ["megakernel", "per_stage"])
def test_cuda_pooled_hop_after_eviction(backend):
    """Model b takes pool row 1, runs and leaves; model c's admission
    evicts it.  A stream of c then gives, hop for hop and at its close,
    what a single-model scheduler of c gives on the card: the kernels
    read row 1 of every laid-out copy, not only the raw weights."""
    dev = _cuda()
    spec = kws.build_kws_spec()
    kw = dict(capacity=16, hop_frames=8, backend=backend, device=dev)
    w0, t0 = _model(spec, 1)
    s = StreamScheduler(spec, w0, t0, max_models=2, tenant_block=8, **kw)
    pin = s.add_stream()  # keeps the default model resident
    clip = np.random.default_rng(9).integers(0, 256, 6000, dtype=np.uint8)
    assert s.register_model("b", *_model(spec, 2)) == 1
    sb = s.add_stream(model="b")
    s.push_audio(sb, clip)
    s.drain()
    s.close_stream(sb)
    wc, tc = _model(spec, 3)
    assert s.register_model("c", wc, tc) == 1
    s.close_stream(pin)
    single = StreamScheduler(spec, wc, tc, **kw)
    runs = []
    for sched, model in ((s, "c"), (single, None)):
        hops = []
        _record_hops(sched, hops)
        sid = sched.add_stream(7, model=model)
        sched.push_audio(sid, clip)
        with dispatch.counting() as launched:
            sched.drain()
        assert sum(launched().values()) == \
            len(hops) * sched._model.dispatches_per_hop(True)
        runs.append((hops, [], [sched.close_stream(sid).logits]))
    _same_runs(*runs)


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


# (B, l_out, cin, k, stride, cout, bits, K): l_out off the position block,
# cin > 1, 4-bit codes, a K=2 pool by slot
BITSERIAL = [(5, 83, 1, 19, 8, 64, 8, 1), (7, 37, 4, 5, 2, 48, 8, 1),
             (9, 30, 1, 7, 8, 8, 4, 1), (37, 64, 1, 19, 8, 64, 8, 2),
             (3, 45, 16, 3, 1, 32, 4, 2), (1, 2000, 1, 19, 8, 64, 8, 1)]


@pytest.mark.parametrize("b,l_out,cin,k,stride,cout,bits,km", BITSERIAL,
                         ids=str)
def test_cuda_bitserial_step_edge_cases(b, l_out, cin, k, stride, cout, bits,
                                        km):
    dev = _cuda()
    rng = np.random.default_rng(l_out)
    l_in = (l_out - 1) * stride + k + int(rng.integers(0, stride))
    x = torch.as_tensor(rng.integers(0, 1 << 12, (b, l_in, cin)).astype(
        np.int32))
    lead = (km,) if km > 1 else ()
    w = torch.as_tensor(rng.integers(-1, 2, lead + (k, cin, cout)).astype(
        np.int8))
    mi = (torch.as_tensor(rng.integers(0, km, b).astype(np.int32))
          if km > 1 else None)
    kw = dict(bits=bits, stride=stride, l_out=l_out)
    want = bk.bnn_bitserial_step(x, w, mi, **kw)
    with dispatch.counting() as launched:
        got = bk.bnn_bitserial_step(x.to(dev), w.to(dev), None if mi is None
                                    else mi.to(dev), **kw)
    torch.cuda.synchronize()
    assert launched() == {bk.BITSERIAL_KERNEL: 1}
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


# (B, cin, cout, k, stride, l_out, mode, pool, K): cout off the 8-column
# n-tile (and off 4), positions off the 16-row m-tile, stride 2, pools
# 2-4, flush-sized windows, tenants by slot, one word a row
STEP = [(37, 64, 20, 3, 1, 19, "raw", 1, 1),
        (5, 96, 13, 5, 2, 7, "sa", 2, 1),
        (9, 256, 44, 3, 1, 3, "raw", 1, 2),
        (200, 128, 250, 5, 1, 29, "sa", 3, 1),
        (3, 40, 6, 3, 1, 15, "sa", 4, 1),
        (11, 40, 6, 3, 2, 7, "raw", 1, 3),
        (256, 256, 352, 3, 1, 2, "raw", 1, 1),
        (1, 64, 128, 3, 1, 64, "raw", 1, 1),
        (7, 20, 16, 5, 1, 9, "sa", 2, 1)]


def _step_operands(dev, rng, b, cin, cout, k, stride, l_out, mode, km):
    l_in = (l_out - 1) * stride + k + int(rng.integers(0, 3))
    x = ops.pack_activations(torch.as_tensor(rng.integers(
        0, 2, (b, l_in, cin)).astype(np.int32))).contiguous()
    lead = (km,) if km > 1 else ()
    w = torch.as_tensor(rng.integers(-1, 2, lead + (k, cin, cout)).astype(
        np.int32))
    wp, wn = (t.contiguous() for t in ops.pack_weight_planes(w))
    thr = torch.as_tensor(np.round(rng.normal(0, 3, cout)).astype(np.float32))
    thr[:2] = torch.tensor([np.inf, -np.inf])
    flip = torch.as_tensor((rng.random(cout) < 0.3).astype(np.int32))
    mi = (torch.as_tensor(rng.integers(0, km, b).astype(np.int32))
          if km > 1 else None)
    sa = mode == "sa"
    return (x, wp, wn, thr if sa else None, flip if sa else None, mi)


@pytest.mark.parametrize("b,cin,cout,k,stride,l_out,mode,pool,km", STEP,
                         ids=str)
def test_cuda_conv_step_edge_cases(b, cin, cout, k, stride, l_out, mode,
                                   pool, km):
    """B.4 on the 1-bit tensor cores at ragged edges and with tenants,
    through the entry point (its own launch shape), bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(l_out * 13 + cout)
    args = _step_operands(dev, rng, b, cin, cout, k, stride, l_out, mode, km)
    kw = dict(k=k, stride=stride, l_out=l_out, pool=pool, mode=mode)
    want = bk.bnn_conv1d_step(*args, **kw)
    with dispatch.counting() as launched:
        got = bk.bnn_conv1d_step(*(None if a is None else a.to(dev)
                                   for a in args), **kw)
    torch.cuda.synchronize()
    assert launched() == {bk.CONV_STEP_KERNEL: 1}
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("slots", bk.STEP_SLOTS[:5])
@pytest.mark.parametrize("item", bk.STEP_ITEMS)
def test_cuda_conv_step_every_tile(slots, item):
    """Every slot block and MMA item B.4 may take, with a ragged last
    block of slots and of n-tiles, against the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(slots)
    b, cin, cout, k, l_out = 19, 64, 44, 3, 21
    args = _step_operands(dev, rng, b, cin, cout, k, 1, l_out, "raw", 1)
    want = bk.conv_step_plain(*args, k=k, stride=1, l_out=l_out)
    cw = args[0].shape[-1]
    for ntb in (1, 2, 3, 6):
        smem = bk.step_smem(min(slots, b), ntb, cw, k,
                            bk.step_rows(l_out, 1, 1, k))
        tile = bk.StepTile(slots, ntb, *item, smem)
        got = bk._conv_step_cuda(*(None if a is None else a.to(dev)
                                   for a in args), k=k, stride=1,
                                 l_out=l_out, pool=1, mode="raw", tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (slots, ntb, item)


# (B, widths, out_raw, tenant models): one slot, tenants by slot, three
# fc layers, a single raw layer
TAIL = [(1, (352, 512, 12), (False, True), 1),
        (17, (352, 512, 12), (False, True), 3),
        (40, (70, 33, 20, 12), (False, False, True), 3),
        (256, (352, 512, 12), (False, True), 2),
        (5, (40, 24, 12), (False, True), 1),
        (9, (40, 12), (True,), 2)]


def _tail_operands(rng, b, dims, out_raw, km):
    lead = (km,) if km > 1 else ()
    ws, thrs, flips = [], [], []
    for j in range(len(out_raw)):
        ws.append(torch.as_tensor(rng.integers(
            -1, 2, lead + dims[j:j + 2]).astype(np.int8)))
        thr = np.round(rng.normal(0, 40 if j == 0 else 3,
                                  lead + (dims[j + 1],)))
        thr.flat[:2] = (np.inf, -np.inf)
        thrs.append(torch.as_tensor(thr.astype(np.float32)))
        flips.append(torch.as_tensor((rng.random(lead + (dims[j + 1],))
                                      < 0.3).astype(np.int32)))
    gap = torch.as_tensor(rng.integers(0, 400, (b, dims[0])).astype(np.int32))
    mi = (torch.as_tensor(rng.integers(0, km, b).astype(np.int32))
          if km > 1 else None)
    return gap, ws, thrs, flips, mi


@pytest.mark.parametrize("b,dims,out_raw,km", TAIL, ids=str)
def test_cuda_classifier_tail_edge_cases(b, dims, out_raw, km):
    """B.5 in clusters on the int8 tensor cores: one slot, tenants by slot
    in a ragged last cluster, three fc layers, GAP counts past 255; raw
    weights and their laid-out form alike, bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(b + len(dims))
    gap, ws, thrs, flips, mi = _tail_operands(rng, b, dims, out_raw, km)
    want = bk.classifier_tail(gap, ws, thrs, flips, mi, out_raw=out_raw)
    d = lambda xs: [x.to(dev) for x in xs]  # noqa: E731
    md = None if mi is None else mi.to(dev)
    for weights in (d(ws), bk.prepare_tail_weights(d(ws))):
        with dispatch.counting() as launched:
            got = bk.classifier_tail(gap.to(dev), weights, d(thrs),
                                     d(flips), md, out_raw=out_raw)
        torch.cuda.synchronize()
        assert launched() == {bk.TAIL_KERNEL: 1}
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("cluster", bk.TAIL_CLUSTERS)
def test_cuda_classifier_tail_every_block(cluster):
    """Every slot block at every cluster size, with tenants by slot."""
    dev = _cuda()
    rng = np.random.default_rng(cluster)
    gap, ws, thrs, flips, mi = _tail_operands(rng, 37, (352, 512, 12),
                                              (False, True), 2)
    want = bk.classifier_tail(gap, ws, thrs, flips, mi, out_raw=(False, True))
    d = lambda xs: [x.to(dev) for x in xs]  # noqa: E731
    for slots in bk.TAIL_SLOTS:
        got = bk._tail_cuda(gap.to(dev), d(ws), d(thrs), d(flips), mi.to(dev),
                            out_raw=(False, True), slots=slots,
                            cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (slots, cluster)


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


def _sharded_run(sched, clips):
    """Streams join, get their first clip halves, the odd sids leave (the
    even ones crowd shard 0 at S = 2 and 8, so the next hop barrier
    migrates), the rest stream on; returns each sid's (frame, logits)
    hops, a peek and the closes, and the launches per hop."""
    per_sid, launches = {}, []
    fold = sched._fold_hop

    def spy(*args, **kw):
        hb = fold(*args, **kw)
        for r, sid in enumerate(hb.sids.tolist()):
            per_sid.setdefault(sid, []).append(
                (int(hb.frames[r]), hb.logits[r].copy()))
        return hb
    sched._fold_hop = spy
    n = len(clips)
    for sid in range(n):
        sched.add_stream(sid)
    closes = {}
    for half in (0, 1):
        sched.push_audio_batch(list(range(n)) if half == 0 else
                               [j for j in range(n) if j % 2 == 0],
                               [c[:3000] if half == 0 else c[3000:]
                                for j, c in enumerate(clips)
                                if half == 0 or j % 2 == 0])
        n0 = sum(map(len, per_sid.values()))
        with dispatch.counting() as launched:
            hops = sched.drain()
        launches.append((hops, launched()))
        assert sum(map(len, per_sid.values())) > n0
        if half == 0:
            closes.update({j: sched.close_stream(j).logits
                           for j in range(1, n, 2)})
    peek = sched.peek(0)
    closes.update({j: sched.close_stream(j).logits for j in range(0, n, 2)})
    return per_sid, peek, closes, launches


@pytest.mark.parametrize("backend,S,cls", [
    ("megakernel", 2, StreamScheduler), ("megakernel", 8, StreamScheduler),
    ("per_stage", 2, StreamScheduler),
    ("megakernel", 8, AsyncStreamScheduler)], ids=str)
def test_cuda_sharded_scheduler_matches_one_shard(backend, S, cls):
    """The slot pool over S shards of the card: every stream's hops, the
    peek and the closes equal the 1-shard megakernel scheduler's, each
    hop makes S times the per-shard launches, and the skewed leaves fire
    a rebalance."""
    dev = _cuda()
    from repro_torch.launch.mesh import make_stream_mesh
    spec = kws.build_kws_spec()
    weights, thresholds = _model(spec, 6)
    rng = np.random.default_rng(7)
    clips = [rng.integers(0, 256, 9000, dtype=np.uint8) for _ in range(16)]
    kw = dict(capacity=16, hop_frames=8)
    want = _sharded_run(StreamScheduler(spec, weights, thresholds,
                                        device=dev, **kw), clips)
    sched = cls(spec, weights, thresholds, backend=backend,
                mesh=make_stream_mesh(S, device=dev), **kw)
    got = _sharded_run(sched, clips)
    if cls is AsyncStreamScheduler:
        sched.shutdown(timeout=60.0)
    assert got[0].keys() == want[0].keys()
    for sid, seq in got[0].items():
        assert [f for f, _ in seq] == [f for f, _ in want[0][sid]]
        for (_, a), (_, b) in zip(seq, want[0][sid]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    for sid, lg in got[2].items():
        np.testing.assert_array_equal(lg, want[2][sid])
    per = sched._model.dispatches_per_hop(True)
    for hops, launched in got[3]:
        assert sum(launched.values()) == S * per * hops
    assert sched.metrics.rebalances >= 1


@pytest.mark.parametrize("per_card", (1, 2))
def test_cuda_pool_over_every_card(per_card):
    """The slot pool over every visible card, ``per_card`` shards each:
    every shard's state lies on its own card, and every stream's hops,
    the peek and the closes equal the 1-shard scheduler's through the
    skewed leaves and the rebalance between cards."""
    dev = _cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 cards")
    from repro_torch.launch.mesh import ShardRows, make_stream_mesh
    spec = kws.build_kws_spec()
    weights, thresholds = _model(spec, 6)
    rng = np.random.default_rng(7)
    clips = [rng.integers(0, 256, 9000, dtype=np.uint8) for _ in range(16)]
    kw = dict(capacity=16, hop_frames=8)
    want = _sharded_run(StreamScheduler(spec, weights, thresholds,
                                        device=dev, **kw), clips)
    cards = 1 << (n.bit_length() - 1)
    mesh = make_stream_mesh(per_card * cards, cards=cards)
    sched = StreamScheduler(spec, weights, thresholds, mesh=mesh, **kw)
    got = _sharded_run(sched, clips)
    for x in (*sched._tails, *sched._pendings, sched._gap):
        assert isinstance(x, ShardRows) and x.devices == mesh.devices
    assert sched.metrics.rebalances >= 1
    for sid, seq in got[0].items():
        assert [f for f, _ in seq] == [f for f, _ in want[0][sid]]
        for (_, a), (_, b) in zip(seq, want[0][sid]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    for sid, lg in got[2].items():
        np.testing.assert_array_equal(lg, want[2][sid])


# ---------------------------------------------------------------------------
# Kernel library (B.6-B.8)
# ---------------------------------------------------------------------------

# (L, Cin, Cout, k, stride, pad): the full-width utterance's b1-b3, k=7
# stride 2, an even k, and unaligned channels
LIB_CONV = [(2000, 64, 128, 3, 1, 1), (1000, 128, 256, 5, 1, 2),
            (500, 256, 352, 3, 1, 1), (300, 40, 48, 7, 2, 3),
            (33, 8, 12, 2, 2, 0), (129, 100, 65, 5, 1, 2),
            # the chip twin's column chunks of b2 and b3 (b1's is the first)
            (1000, 128, 128, 5, 1, 2), (500, 256, 128, 3, 1, 1),
            (500, 256, 96, 3, 1, 1)]


@pytest.mark.parametrize("pool,mode", [(1, "raw"), (1, "sa"), (2, "sa"),
                                       (4, "sa")])
@pytest.mark.parametrize("l,cin,cout,k,stride,pad", LIB_CONV,
                         ids=["-".join(map(str, c)) for c in LIB_CONV])
def test_cuda_bnn_conv1d_matches_plain(l, cin, cout, k, stride, pad, pool,
                                       mode):
    dev = _cuda()
    rng = np.random.default_rng(l + cin)
    x = torch.as_tensor(rng.integers(0, 2, (l, cin), dtype=np.int32))
    w = torch.as_tensor(rng.integers(-1, 2, (k, cin, cout), dtype=np.int32))
    thr = torch.as_tensor(np.round(rng.normal(0, 4, cout)).astype(
        np.float32))
    thr[:2] = torch.tensor([np.inf, -np.inf])
    flip = torch.as_tensor((rng.random(cout) < 0.3).astype(np.int32))
    kw = dict(stride=stride, pad=pad, pool=pool, mode=mode)
    want = ops.bnn_conv1d(x, w, thr, flip, **kw)
    with dispatch.counting() as launched:
        got = ops.bnn_conv1d(x.to(dev), w.to(dev), thr.to(dev),
                             flip.to(dev), **kw)
    torch.cuda.synchronize()
    assert launched() == {bk.CONV_KERNEL: 1}
    assert got.dtype == want.dtype and got.shape == want.shape
    want = want.view(torch.int32)
    assert torch.equal(got.view(torch.int32).cpu(), want)
    # every launch shape the rule can choose: each block of pooled
    # positions and of n-tiles that fits, with every MMA item, over the
    # input as ops packs it and over one that starts off 16 bytes (the
    # kernel then copies word by word)
    cw = ops.conv_weights(w.to(dev))
    xq = ops.pack_activations(x.to(dev)).contiguous()
    off = torch.empty(xq.numel() + 1, dtype=torch.int32, device=dev)
    off[1:] = xq.reshape(-1)
    xs = (xq, off[1:].view(xq.shape))
    sa = mode == "sa"
    npool = pool if sa else 1
    l_out = (l + 2 * pad - k) // stride + 1
    n_pos, nt, words = l_out // npool, -(-cout // 8), xq.shape[1]
    args = (cw.wp, cw.wn) + ((thr.to(dev), flip.to(dev)) if sa
                             else (None, None))
    for pb in bk.CONV_BLOCKS:
        for ntb in sorted({-(-nt // (1 << i))
                           for i in range(nt.bit_length() + 1)}):
            smem = bk.block_smem(min(pb, n_pos), ntb, words, k, stride,
                                 npool)
            if smem > bk.MAX_SMEM:
                continue
            for item in bk.STEP_ITEMS:
                tile = bk.BlockTile(pb, ntb, *item, smem)
                for xx in xs:
                    got = bk._conv1d_cuda(xx, *args, k=k, stride=stride,
                                          pad=pad, l_out=l_out, pool=npool,
                                          mode=mode, wf=cw.wf, tile=tile)
                    torch.cuda.synchronize()
                    assert torch.equal(got.cpu(), want), tile


# (M, K, N): kernel_bench's GEMMs, the utterance's fc1 bit planes and fc2,
# the chip twin's fc1 bit-plane column chunk and fc2 row slice,
# test_kernels' unaligned shapes, a contraction of several 32-word
# chunks, then shapes on both sides of the tile thresholds (M = 12 / 13
# for B.8's GEMV / wgmma tiles, 16 / 17 for B.7's row blocks, 64 / 65 for
# a second 64-row tile, 384 / 385 at N = 4096 for B.8's K-split / 128 x 256
# wgmma tiles, 2048 / 2049 at N = 512 for B.7's GEMV / 64 x 64 tiles) with
# ragged N and K
LIB_GEMM = [(1, 1024, 512), (256, 1024, 512), (8, 352, 512), (1, 512, 12),
            (8, 352, 128), (1, 256, 12),
            (7, 100, 12), (33, 513, 65), (70, 2100, 130),
            (2, 32, 65), (12, 1024, 512), (13, 100, 130), (16, 513, 130),
            (17, 1024, 12), (64, 100, 4096), (65, 2100, 512),
            (256, 32, 130), (384, 100, 4096), (385, 513, 4096),
            (2048, 100, 512), (2049, 32, 512), (8192, 513, 65)]


@pytest.mark.parametrize("m,k,n", LIB_GEMM, ids=str)
def test_cuda_twm_linear_matches_plain(m, k, n):
    dev = _cuda()
    rng = np.random.default_rng(m + k + n)
    x = torch.as_tensor(rng.integers(0, 2, (m, k), dtype=np.int32))
    w = torch.as_tensor(rng.integers(-1, 2, (k, n), dtype=np.int32))
    thr = torch.as_tensor(np.round(rng.normal(0, 3, n)).astype(np.float32))
    thr[:2] = torch.tensor([np.inf, -np.inf])
    flip = torch.as_tensor((rng.random(n) < 0.4).astype(np.int32))
    calls = [("twm_matmul", lambda *a: ops.twm_linear(*a[:2], mode="raw")),
             ("twm_matmul", lambda *a: ops.twm_linear(*a, mode="sa")),
             ("twm_matmul_mxu", lambda *a: ops.twm_linear_mxu(*a))]
    for name, fn in calls:
        want = fn(x, w, thr, flip)
        with dispatch.counting() as launched:
            got = fn(x.to(dev), w.to(dev), thr.to(dev), flip.to(dev))
        torch.cuda.synchronize()
        assert launched() == {name: 1}
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int32).cpu(),
                           want.view(torch.int32)), name


def _gemm_operands(m, k, n, dev):
    """B.7's and B.8's prepared operands on the card, as ``ops`` makes
    them, with +-inf thresholds and flips."""
    from repro_torch.core import quant
    from repro_torch.kernels import twm_matmul as tm

    rng = np.random.default_rng(m * 7 + k + n)
    x = torch.as_tensor(rng.integers(0, 2, (m, k), dtype=np.int32))
    w = torch.as_tensor(rng.integers(-1, 2, (k, n), dtype=np.int32))
    thr = torch.as_tensor(np.round(rng.normal(0, 3, n)).astype(np.float32))
    thr[:2] = torch.tensor([np.inf, -np.inf])
    flip = torch.as_tensor((rng.random(n) < 0.4).astype(np.int32))
    xq = ops.pack_activations(x).contiguous()
    wp, wn = (p.contiguous() for p in ops.pack_weight_planes(w))
    x8 = quant.pad_to_multiple(x.to(torch.int8), tm.MXU_K, 1).contiguous()
    wt8 = quant.pad_to_multiple(w.to(torch.int8).t(), tm.MXU_K,
                                1).contiguous()
    return [t.to(dev) for t in (xq, wp, wn, thr, flip, x8, wt8)]


# (M, K, N) on each side of the thresholds, every tile forced on each
FORCED = [(1, 1024, 512), (12, 1024, 512), (13, 100, 4096), (16, 513, 130),
          (17, 100, 12), (65, 2100, 65), (256, 1024, 512)]


@pytest.mark.parametrize("m,k,n", FORCED, ids=str)
def test_cuda_every_gemm_tile_matches_plain(m, k, n):
    """Each tile of B.7 (GEMV-shaped, 64 x 64) and B.8 (GEMV-shaped,
    wgmma 128 x 256 and 64 x 64 K-split, each with one tile per CTA and
    with 3 persistent CTAs walking the tiles) is bit-equal to the plain
    version whichever side of its threshold the shape lies."""
    from repro_torch.kernels import twm_matmul as tm

    dev = _cuda()
    xq, wp, wn, thr, flip, x8, wt8 = _gemm_operands(m, k, n, dev)
    kw, kp = xq.shape[1], x8.shape[1]
    gemv = tm._popcount_tile(1, kw, n)
    rows = tm._rows_per_cta(m)
    b7 = [gemv._replace(rows=rows, grid=(gemv.grid[0], -(-m // rows))),
          tm.Tile("tile64", 1, 64, 64, 1, (-(-n // 64), -(-m // 64)))]
    for tile in b7:
        for mode in ("raw", "sa"):
            args = (xq, wp, wn) + ((thr, flip) if mode == "sa" else ())
            got = tm._twm_cuda(*args, *(None,) * (5 - len(args)), mode=mode,
                               tile=tile)
            want = tm.twm_matmul_plain(*args, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (tile, mode)
    g8 = tm._mxu_tile(1, n, kp)
    b8 = [g8._replace(rows=rows, grid=(g8.grid[0], -(-m // rows)))]
    for code, bm, bn, split in tm._WGMMA_TILES:
        tiles = -(-m // bm) * -(-n // bn)
        for ctas in {min(tiles, 132), min(tiles, 3)}:  # 3: CTAs walk tiles
            b8.append(tm.Tile(f"wgmma{bm}x{bn}", code, bm, bn, split,
                              (ctas, 1)))
    want = tm.twm_matmul_mxu_plain(x8, wt8, thr, flip)
    for tile in b8:
        got = tm._mxu_cuda(x8, wt8, thr, flip, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


# ---------------------------------------------------------------------------
# The chip twin (core.compiler / core.executor) on the card
# ---------------------------------------------------------------------------

def _chip_twin_spec(name):
    """The smoke spec, or a seeded random geometry: a bit-serial first
    conv (4 or 8 bits, random k / stride / pad), 1-3 binary convs of up to
    160 channels (two column chunks) with random k / pad / pool, GAP, a
    bit-serial fc of up to 200 channels and a raw fc."""
    if name == "smoke":
        return kws.build_kws_smoke_spec()
    rng = np.random.default_rng(int(name[4:]))
    k0, bits0 = int(rng.integers(3, 13)), int(rng.choice([4, 8]))
    layers = [Conv1DSpec(1, int(rng.choice([8, 32, 64])), k=k0,
                         stride=int(rng.choice([2, 4, 8])),
                         pad=int(rng.integers(0, k0)), in_bits=bits0,
                         in_offset=1 << (bits0 - 1), name="l0")]
    for j in range(int(rng.integers(1, 4))):
        k = int(rng.choice([3, 5]))
        layers.append(Conv1DSpec(layers[-1].cout,
                                 int(rng.choice([8, 48, 96, 160])), k=k,
                                 pad=int(rng.integers(0, k // 2 + 1)),
                                 pool=int(rng.choice([1, 2, 4])),
                                 name=f"b{j + 1}"))
    cin, hidden = layers[-1].cout, int(rng.choice([16, 200]))
    layers += [GAPSpec(cin, name="gap"),
               FCSpec(cin, hidden, in_bits=8, name="fc1"),
               FCSpec(hidden, 12, out_raw=True, name="fc2")]
    return CNN1DSpec(in_len=1500, in_channels=1, in_bits=bits0,
                     layers=tuple(layers), name=name)


@pytest.mark.parametrize("fuse_pool", [True, False])
@pytest.mark.parametrize("name", ["smoke", "rand1", "rand2"])
def test_cuda_executor_matches_cpu(name, fuse_pool):
    """The executor on the card (one B.3 / B.6 raw / B.7 raw launch per
    MAC chunk) gives the CPU run's whole report."""
    from repro_torch.core import compiler, executor

    dev = _cuda()
    spec = _chip_twin_spec(name)
    weights, thresholds = _model(spec, 3)
    x = np.random.default_rng(4).integers(
        0, 1 << spec.in_bits, (spec.in_len, 1)).astype(np.uint8)
    reps = []
    for d in ("cpu", dev):
        prog = compiler.compile_model(spec, weights, thresholds, device=d)
        assert prog.cim.pos.device.type == torch.device(d).type
        with dispatch.counting() as launched:
            reps.append(executor.Executor(prog, fuse_pool=fuse_pool).run(x))
        n_mac = sum(k == "mac" for k, _ in prog.instr_meta)
        assert sum(launched().values()) == n_mac
    torch.cuda.synchronize()
    cpu, card = reps
    assert card.output.device.type == "cuda"
    assert torch.equal(card.output.cpu(), cpu.output)
    assert sorted(card.fmaps) == sorted(cpu.fmaps)
    for li, fm in cpu.fmaps.items():
        assert torch.equal(card.fmaps[li].cpu(), fm), li
    assert card.layer_cycles == cpu.layer_cycles
    assert np.array_equal(card.bank_active_cycles, cpu.bank_active_cycles)
    assert dataclasses.asdict(card.ledger) == dataclasses.asdict(cpu.ledger)


# ---------------------------------------------------------------------------
# KWS training on the card (models.kws QAT graph, train.loop)
# ---------------------------------------------------------------------------

def _kws_train_step(spec, device):
    from repro_torch.train import loop, optimizer

    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(lr=2e-3, clip_norm=1.0),
                            warmup_steps=0, total_steps=10)
    step = loop.make_train_step(
        None, tcfg, lambda p, b: kws.kws_loss(p, *b, spec))
    params = kws.init_kws_params(
        spec, generator=torch.Generator().manual_seed(2), device=device)
    return step, loop.init_train_state(tcfg, params)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_cuda_qat_forward_matches_cpu(full):
    """The card's QAT forward equals the CPU's bit for bit on the same
    params (init from one CPU generator), every pre-activation an
    integer: no TF32, no inexact algorithm."""
    from repro_torch.data import gscd
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    spec = kws.build_kws_spec() if full else kws.build_kws_smoke_spec()
    params = kws.init_kws_params(
        spec, generator=torch.Generator().manual_seed(1), device=dev)
    x, _ = gscd.batch(seed=3, step=0, batch_size=4, n=spec.in_len)
    pre_card, pre_cpu = [], []
    with torch.no_grad():
        got = kws.kws_forward(params, torch.as_tensor(x, device=dev), spec,
                              preacts=pre_card)
        want = kws.kws_forward(tree_map(lambda t: t.cpu(), params),
                               torch.as_tensor(x), spec, preacts=pre_cpu)
    assert got.device.type == "cuda" and got.shape == (4, 12)
    assert torch.equal(got.cpu(), want)
    assert len(pre_card) == len(pre_cpu) == 6
    for a, b in zip(pre_card, pre_cpu):
        assert torch.equal(a, a.round()) and torch.equal(a.cpu(), b)


def test_cuda_train_step_matches_cpu():
    """One AdamW step on the card and on the CPU from the same params and
    batch: the loss within 1e-5 relative; every gradient leaf within rtol
    1e-4 and atol 1e-6 x its max |g| (float32 sums in another order);
    the masters within atol 1e-5 (lr / 200): where a clipped gradient is
    near Adam's eps (1e-8) the update is ~lr * g / eps, linear in g, and
    carries the gradients' last-bit differences; and the same ternary
    weights after export."""
    from repro_torch.data import gscd
    from repro_torch.train import loop
    from repro_torch.utils.tree import tree_leaves

    dev = _cuda()
    spec = kws.build_kws_smoke_spec()
    x, y = gscd.batch(seed=0, step=0, batch_size=4, n=spec.in_len)
    out = []
    for d in (dev, torch.device("cpu")):
        step, state = _kws_train_step(spec, d)
        batch = (torch.as_tensor(x, device=d), torch.as_tensor(y, device=d))
        _, grads = loop.value_and_grad(
            lambda p, b: kws.kws_loss(p, *b, spec), state["params"], batch)
        state, m = step(state, batch)
        out.append((state, float(m["loss"]), grads))
    (card, loss_card, g_card), (cpu, loss_cpu, g_cpu) = out
    assert loss_card == pytest.approx(loss_cpu, rel=1e-5)
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()))
    for a, b in zip(tree_leaves(card["opt"]["master"]),
                    tree_leaves(cpu["opt"]["master"])):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    w_card, _ = kws.export_kws(card["params"], spec)
    w_cpu, _ = kws.export_kws(cpu["params"], spec)
    for li in w_cpu:
        assert np.array_equal(w_card[li], w_cpu[li]), li


def test_cuda_deploy_matches_qat():
    """Two training steps on the card, then the export through
    ``offline_logits`` and the chip twin's executor on the card: both
    equal the QAT logits bit for bit."""
    from repro_torch.core import compiler, executor
    from repro_torch.data import gscd

    dev = _cuda()
    spec = kws.build_kws_smoke_spec()
    step, state = _kws_train_step(spec, dev)
    for i in range(2):
        x, y = gscd.batch(seed=0, step=i, batch_size=4, n=spec.in_len)
        state, _ = step(state, (torch.as_tensor(x, device=dev),
                                torch.as_tensor(y, device=dev)))
    params = state["params"]
    weights, thresholds = kws.export_kws(params, spec)
    xe, _ = gscd.batch(seed=7, step=10_000, batch_size=3, n=spec.in_len)
    with torch.no_grad():
        qat = kws.kws_forward(params, torch.as_tensor(xe, device=dev), spec)
    model = kws.prepare_offline(spec, weights, thresholds, device=dev)
    prog = compiler.compile_model(spec, weights, thresholds, device=dev)
    for clip, want in zip(xe, qat.to(torch.int64)):
        off = kws.offline_logits(model, torch.as_tensor(clip, device=dev))
        rep = executor.Executor(prog).run(clip[:, None])
        torch.cuda.synchronize()
        assert torch.equal(off.to(torch.int64), want)
        assert torch.equal(rep.output.ravel().to(torch.int64), want)


# ---------------------------------------------------------------------------
# LM serving (A.13): the engine on the card against the CPU
# ---------------------------------------------------------------------------

#: logits tolerance of the LM cases (tests/test_torch_lm.py's) and the
#: reference's own prefill/decode bound for the full-width model
LM_RTOL, LM_ATOL = 0.02, 0.08
LM_REF_RTOL, LM_REF_ATOL = 0.06, 0.15


def _lm_run(cfg, params, asyn):
    """6 requests through 2 slots at max_seq 16 (the shared clock passes
    it) -> (tokens by rid, each request's logits row per token: the
    prefill's, then each decode tick's)."""
    from repro_torch.serve import engine

    eng = engine.Engine(cfg, params, batch_slots=2, max_seq=16)
    rows: dict = {}
    firsts: list = []
    decode, prefill = eng._decode, eng._prefill_one

    def rec_decode(p, state, last):
        logits, state = decode(p, state, last)
        out = logits[:, -1].float().cpu()
        for slot, req in enumerate(eng.slot_req):
            if req is not None:
                rows.setdefault(req.rid, []).append(out[slot])
        return logits, state

    def rec_prefill(*args):
        state, last = prefill(*args)
        firsts.append(last.float().cpu())
        return state, last

    eng._decode, eng._prefill_one = rec_decode, rec_prefill
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
            max_new_tokens=(8, 3, 8, 3, 5, 5)[i]))
    done = (eng.run_until_drained_async() if asyn
            else eng.run_until_drained())
    assert int(eng.state["cache_len"]) > 16
    fills = [e["rid"] for e in eng.obs.events.tail()
             if e["event"] == "lm_slot_fill"]
    return ({r.rid: r.out_tokens for r in done},
            {rid: [first] + rows.get(rid, [])
             for rid, first in zip(fills, firsts)})


@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "phi-3-vision-4.2b"])
def test_cuda_engine_tokens_match_cpu(name, asyn):
    """The engine on the card gives the CPU's tokens at smoke size; where
    one differs, the CPU's logits there are a near tie (its logit of its
    own token exceeds that of the card's token by at most LM_ATOL), and
    that request is compared no further."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    cfg = get_arch(name, smoke=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    want, rows = _lm_run(cfg, params, asyn)
    got, _ = _lm_run(cfg, tree_map(lambda t: t.to(dev), params), asyn)
    assert got.keys() == want.keys()
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks) == len(rows[rid])
        for j, (a, b) in enumerate(zip(toks, got[rid])):
            row = rows[rid][j][:cfg.vocab]
            assert int(row.argmax()) == a
            if a != b:
                assert float(row[a] - row[b]) <= LM_ATOL, (rid, j)
                break


@pytest.mark.parametrize("name", ["qwen3-0.6b", "yi-9b",
                                  "phi-3-vision-4.2b"])
def test_cuda_lm_decode_matches_cpu(name):
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    cfg = get_arch(name, smoke=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    card = tree_map(lambda t: t.to(dev), params)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    dec = api.decode_fn(cfg)
    s_cpu = api.init_decode_state(cfg, 2, 8, device="cpu")
    s_card = api.init_decode_state(cfg, 2, 8, device=dev)
    for t in range(10):           # past max_seq: the clamped write
        a, s_cpu = dec(params, s_cpu, toks[:, t:t + 1])
        b, s_card = dec(card, s_card, toks[:, t:t + 1].to(dev))
        torch.testing.assert_close(b.cpu(), a, rtol=LM_RTOL, atol=LM_ATOL)
    assert int(s_card["cache_len"]) == 10


def test_cuda_full_width_prefill_matches_cpu():
    """Qwen3-0.6B at its published width and depth: prefill logits on the
    card within the reference's bound of the CPU's, same params."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    cfg = get_arch("qwen3-0.6b")
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 16)).astype(
        np.int32)
    prefill = api.prefill_fn(cfg)
    got, caches = prefill(params, {"tokens": torch.as_tensor(toks,
                                                             device=dev)})
    want, _ = prefill(tree_map(lambda t: t.cpu(), params),
                      {"tokens": torch.as_tensor(toks)})
    assert got.shape == (1, 16, cfg.padded_vocab) and len(caches) == 1
    torch.testing.assert_close(got.cpu(), want, rtol=LM_REF_RTOL,
                               atol=LM_REF_ATOL)


# ---------------------------------------------------------------------------
# LM serving, the other families (A.13b): MoE, SSM, hybrid, encoder-decoder
# ---------------------------------------------------------------------------

LM_FAMILIES = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "xlstm-350m",
               "jamba-1.5-large-398b", "seamless-m4t-medium"]


def _lm_smoke(name, seed=0):
    from repro_torch.configs import get_arch
    from repro_torch.models import api

    cfg = get_arch(name, smoke=True)
    return cfg, api.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def _lm_ticks(cfg, params, asyn):
    """4 requests of equal length through 2 slots (every row live at every
    tick, so no empty row competes for expert capacity) -> (tokens by
    rid, the tokens fed to each row per tick, the logits of each row per
    tick)."""
    from repro_torch.serve import engine

    eng = engine.Engine(cfg, params, batch_slots=2, max_seq=32)
    feeds, rows = [], []
    decode = eng._decode

    def traced(p, state, last):    # the ticks only: a prefill has its own
        logits, state = decode(p, state, last)
        feeds.append(last.cpu().ravel().tolist())
        rows.append(logits[:, -1].float().cpu())
        return logits, state

    eng._decode = traced
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 5).astype(np.int32),
            max_new_tokens=6))
    done = (eng.run_until_drained_async() if asyn
            else eng.run_until_drained())
    return {r.rid: r.out_tokens for r in done}, feeds, rows


@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("name", LM_FAMILIES)
def test_cuda_lm_families_engine_matches_cpu(name, asyn):
    """The engine on the card against the CPU at smoke size: the tokens fed
    to every row are equal tick by tick up to the first tick where one
    differs; there each differing token was a near tie of the CPU's
    logits of its row one tick before (its logit of its own token exceeds
    that of the card's by at most LM_ATOL).  Under the dropping MoE
    dispatch the rows share expert capacity, so nothing after that tick
    is compared."""
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    cfg, params = _lm_smoke(name)
    want, want_feeds, want_rows = _lm_ticks(cfg, params, asyn)
    got, feeds, _ = _lm_ticks(cfg, tree_map(lambda t: t.to(dev), params),
                              asyn)
    assert got.keys() == want.keys() and len(feeds) == len(want_feeds)
    split = next((i for i, (a, b) in enumerate(zip(want_feeds, feeds))
                  if a != b), None)
    if split is None:
        assert got == want
        return
    for row, (a, b) in enumerate(zip(want_feeds[split], feeds[split])):
        if a != b:
            logits = want_rows[split - 1][row, :cfg.vocab]
            assert int(logits.argmax()) == a
            assert float(logits[a] - logits[b]) <= LM_ATOL, (split, row)


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_cuda_lm_families_decode_and_prefill_match_cpu(name):
    """10 decode steps (past max_seq) and the prefill on the card against
    the CPU, the same params; the encoder-decoder with frame embeddings."""
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    cfg, params = _lm_smoke(name, 1)
    card = tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 10)).astype(
        np.int32))
    dec = api.decode_fn(cfg)
    s_cpu = api.init_decode_state(cfg, 2, 8, device="cpu")
    s_card = api.init_decode_state(cfg, 2, 8, device=dev)
    for t in range(10):
        a, s_cpu = dec(params, s_cpu, toks[:, t:t + 1])
        b, s_card = dec(card, s_card, toks[:, t:t + 1].to(dev))
        torch.testing.assert_close(b.cpu(), a, rtol=LM_RTOL, atol=LM_ATOL)
    assert int(s_card["cache_len"]) == 10
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frontend"] = torch.as_tensor(rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    prefill = api.prefill_fn(cfg)
    want, _ = prefill(params, batch)
    got, _ = prefill(card, tree_map(lambda t: t.to(dev), batch))
    torch.testing.assert_close(got.cpu(), want, rtol=LM_RTOL, atol=LM_ATOL)


def test_cuda_mamba_prefill_then_step_continues():
    """A Mamba layer on the card: the chunked prefill then one step equals
    the prefill of one more token (the reference's tests/test_ssm.py
    contract, its bound)."""
    from repro_torch.models import ssm

    dev = _cuda()
    p = ssm.init_mamba(torch.Generator(device=dev).manual_seed(0), 16,
                       d_state=8, device=dev)
    x = torch.randn(1, 41, 16, generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    full, _ = ssm.mamba_prefill(p, x, d_state=8)
    _, st = ssm.mamba_prefill(p, x[:, :40], d_state=8)
    out, _ = ssm.mamba_step(p, x[:, 40:], st, d_state=8)
    torch.testing.assert_close(out[:, 0].float(), full[:, -1].float(),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("name", LM_FAMILIES + ["qwen3-0.6b"])
def test_cuda_lm_decode_step_does_not_sync(name):
    """A decode step (the router, the dispatch's scatter and gathers, the
    recurrent states written in place) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync in it."""
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    dev = _cuda()
    cfg, params = _lm_smoke(name)
    params = tree_map(lambda t: t.to(dev), params)
    state = api.init_decode_state(cfg, 3, 8, device=dev)
    tok = torch.ones(3, 1, dtype=torch.int32, device=dev)
    dec = api.decode_fn(cfg)
    logits, state = dec(params, state, tok)           # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, state = dec(params, state, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all()) and int(state["cache_len"]) == 3
