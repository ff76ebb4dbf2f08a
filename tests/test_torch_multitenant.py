"""Port parity, tenant weight pool: ``repro_torch``'s ``StreamScheduler(
max_models=K)`` on the CPU against the reference's pooled scheduler
(``backend="jnp"``) and against single-model schedulers, on the smoke
spec (the contracts of the reference's ``tests/test_multitenant.py``).

  * mixed tenants on the ``torch``, ``megakernel`` and ``per_stage``
    backends, and over seeds: per-hop sids, frames, logits and
    detections equal the reference's pooled scheduler (posteriors within
    ``atol=1e-6, rtol=1e-5``: two softmax libraries), and every stream's
    close logits equal a single-model scheduler of its tenant fed the
    same audio; the async plane with tenants equals the same;
  * the launches of a hop do not depend on K (1, 4, 8);
  * ``WeightPool`` admission, LRU eviction among unpinned variants,
    refcounts, re-admission as a touch; a single-model scheduler rejects
    tenancy; the per-tenant metrics split;
  * a pool row reused after an eviction runs the new model, on the
    megakernel and per-stage backends, and every laid-out copy of the row
    (the hop kernel's, B.4's, B.5's) equals the new model's own layout.
"""
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro.stream import StreamScheduler as RefScheduler
from repro_torch.kernels import dispatch
from repro_torch.stream import (
    DEFAULT_MODEL,
    AsyncStreamScheduler,
    StreamScheduler,
    WeightPool,
)

BACKENDS = ("torch", "megakernel", "per_stage")


@pytest.fixture(scope="module")
def spec():
    return ref_kws.build_kws_smoke_spec()


@pytest.fixture(scope="module")
def pspec(spec):
    return cases.port_spec(spec)


@pytest.fixture(scope="module")
def variants(spec):
    """Four tenant variants of the smoke geometry: distinct init seeds ->
    distinct ternary weights + SA thresholds."""
    return {name: cases.exported(spec, seed)
            for name, seed in [(DEFAULT_MODEL, 0), ("b", 7), ("c", 11),
                               ("d", 13)]}


def _clip(spec, seed, n=None):
    return np.random.default_rng(seed).integers(
        0, 256, (n or spec.in_len,)).astype(np.uint8)


def _feed(s, sid, audio, chunk=320):
    for j in range(0, len(audio), chunk):
        s.push_audio(sid, audio[j:j + chunk])


def _drain(s):
    s.run_until_starved()
    s.drain()


def _pooled(pspec, variants, *, max_models=4, backend="megakernel",
            cls=StreamScheduler, **kw):
    w0, t0 = variants[DEFAULT_MODEL]
    if cls is AsyncStreamScheduler:
        kw.setdefault("use_pump", False)
    s = cls(pspec, w0, t0, max_models=max_models, tenant_block=2,
            backend=backend, device="cpu", **kw)
    for name in list(variants)[1:max_models]:
        s.register_model(name, *variants[name])
    return s


# ---------------------------------------------------------------------------
# Mixed tenants: pooled port == pooled reference == single-model, per slot
# ---------------------------------------------------------------------------

def _scenario(sched, spec, rng, names):
    """One randomized mixed-tenant scenario on ``sched``: random binding,
    ragged clips, a close wave (shrink pressure) and a second join wave
    (grow pressure).  Returns (binding, clips, consumed, close logits)."""
    binding = [str(rng.choice(names)) for _ in range(6)]
    clips = [_clip(spec, 100 * int(rng.integers(0, 1 << 20)) + i,
                   480 + 160 * int(rng.integers(0, 4))) for i in range(6)]
    model = lambda m: None if m == DEFAULT_MODEL else m  # noqa: E731
    sids = [sched.add_stream(model=model(m)) for m in binding]
    for sid, a in zip(sids, clips):
        _feed(sched, sid, a[: len(a) // 2])
    _drain(sched)
    closed = {i: sched.close_stream(sids[i]).logits for i in range(0, 6, 3)}
    for i in range(6, 10):
        binding.append(str(rng.choice(names)))
        clips.append(_clip(spec, 100 * int(rng.integers(0, 1 << 20)) + i,
                           640))
        sids.append(sched.add_stream(model=model(binding[i])))
        _feed(sched, sids[i], clips[i])
    for i in range(6):
        if i not in closed:
            _feed(sched, sids[i], clips[i][len(clips[i]) // 2:])
    _drain(sched)
    results = dict(closed)
    for i in range(10):
        if i not in results:
            results[i] = sched.close_stream(sids[i]).logits
    consumed = [len(clips[i]) // 2 if i in closed else len(clips[i])
                for i in range(10)]
    return binding, clips, consumed, results


def _check_mixed(spec, pspec, variants, seed, backend,
                 cls=StreamScheduler):
    K = int(np.random.default_rng(seed).choice([1, 2, 4]))
    names = list(variants)[:K]
    kw = dict(capacity=16, hop_frames=2)
    port = _pooled(pspec, variants, max_models=max(K, 2), backend=backend,
                   cls=cls, **kw)
    w0, t0 = variants[DEFAULT_MODEL]
    ref = RefScheduler(spec, w0, t0, max_models=max(K, 2), tenant_block=2,
                       backend="jnp", **kw)
    for name in list(variants)[1:max(K, 2)]:
        ref.register_model(name, *variants[name])
    port_hops, ref_hops = [], []
    cases.record_hops(port, port_hops)
    cases.record_hops(ref, ref_hops)
    got = _scenario(port, spec, np.random.default_rng(seed), names)
    want = _scenario(ref, spec, np.random.default_rng(seed), names)
    if cls is AsyncStreamScheduler:
        assert port.in_flight == 0
        port.shutdown()
    cases.same_hops(port_hops, ref_hops, exact_post=False)
    binding, clips, consumed, results = got
    for i in range(10):
        np.testing.assert_array_equal(results[i], want[3][i])
        # one single-model scheduler of the stream's tenant, fed alike
        w, t = variants[binding[i]]
        one = StreamScheduler(pspec, w, t, capacity=4, hop_frames=2,
                              backend=backend, device="cpu")
        sid = one.add_stream()
        _feed(one, sid, clips[i][:consumed[i]])
        one.run_until_starved()
        np.testing.assert_array_equal(
            results[i], one.close_stream(sid).logits,
            err_msg=f"stream {i} tenant {binding[i]}")
    assert len(port_hops) > 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_tenant_bitexact(spec, pspec, variants, backend):
    _check_mixed(spec, pspec, variants, seed=1, backend=backend)


@pytest.mark.parametrize("seed", range(2, 5))
def test_mixed_tenant_bitexact_seeds(spec, pspec, variants, seed):
    _check_mixed(spec, pspec, variants, seed=seed, backend="megakernel")


@pytest.mark.parametrize("backend", ("megakernel", "per_stage"))
def test_mixed_tenant_async_matches_sync(spec, pspec, variants, backend):
    """The async plane with a tenant pool (epoch barriers on
    ``register_model`` and resizes) equals the reference's pooled
    scheduler and the single-model schedulers."""
    _check_mixed(spec, pspec, variants, seed=6, backend=backend,
                 cls=AsyncStreamScheduler)


# ---------------------------------------------------------------------------
# Launches per hop do not depend on K
# ---------------------------------------------------------------------------

def _hop_launches(sched, emit: bool, pooled: bool) -> int:
    plan = sched.plan
    B = sched.capacity
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    args = (z(B, plan.hop_samples), torch.ones(B, dtype=torch.bool),
            tuple(z(B, st.tail, st.cin) for st in plan.convs),
            tuple(z(B, st.phase, st.cout) for st in plan.convs),
            z(B, plan.gap_channels))
    if pooled:
        # every tenant row in use, one per block of 2
        args = args + (torch.arange(B, dtype=torch.int32) // 2
                       % sched._model.pool_size,)
    with dispatch.counting() as launched:
        sched._model.step(*args, emit=emit)
    return sum(launched().values())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("K", (1, 4, 8))
def test_dispatches_per_hop_k_independent(pspec, variants, backend, K):
    """A K-tenant hop makes the single-model scheduler's launches on every
    backend — the pool rides the same batched launches, never one per
    tenant: 1 per megakernel hop, emit included."""
    w0, t0 = variants[DEFAULT_MODEL]
    kw = dict(capacity=16, initial_capacity=16, min_capacity=16,
              hop_frames=2, backend=backend, device="cpu")
    base = StreamScheduler(pspec, w0, t0, **kw)
    s = StreamScheduler(pspec, w0, t0, max_models=max(K, 2), tenant_block=2,
                        **kw)
    for emit in (False, True):
        static = base._model.dispatches_per_hop(emit)
        assert s._model.dispatches_per_hop(emit) == static
        assert _hop_launches(base, emit, pooled=False) == static
        assert _hop_launches(s, emit, pooled=True) == static
    if backend == "megakernel":
        assert s._model.dispatches_per_hop(True) == 1


# ---------------------------------------------------------------------------
# WeightPool admission / LRU eviction / refcounts
# ---------------------------------------------------------------------------

def test_pool_lru_eviction_and_refcounts(pspec, variants):
    w0, t0 = variants[DEFAULT_MODEL]
    s = StreamScheduler(pspec, w0, t0, capacity=16, max_models=2,
                        tenant_block=2, device="cpu")
    sid0 = s.add_stream()  # pins DEFAULT_MODEL (refcount 1)
    s.register_model("b", *variants["b"])
    s.register_model("c", *variants["c"])  # evicts b: only refcount-0 row
    assert [m for m, _ in s.models] == [DEFAULT_MODEL, "c"]
    sidc = s.add_stream(model="c")
    with pytest.raises(MemoryError, match="weight pool full"):
        s.register_model("d", *variants["d"])  # every row pinned
    s.close_stream(sidc)  # c's refcount -> 0
    row = s.register_model("d", *variants["d"])
    assert [m for m, _ in s.models] == [DEFAULT_MODEL, "d"]
    assert row == 1  # reuses c's freed row, never grows the stack
    with pytest.raises(KeyError, match="unknown model"):
        s.add_stream(model="nope")
    s.close_stream(sid0)
    ts = s.metrics.tenant_summary()
    assert ts["models_admitted"] == 3 and ts["models_evicted"] == 2
    assert [e["model"] for e in s.obs.events.tail()
            if e["event"] == "model_evict"] == ["b", "c"]


def test_pool_readmit_is_touch_not_swap(pspec, variants):
    """Re-registering a resident tenant moves no row and re-lays out
    nothing — it only refreshes LRU recency."""
    w0, t0 = variants[DEFAULT_MODEL]
    s = StreamScheduler(pspec, w0, t0, capacity=16, max_models=3,
                        tenant_block=2, device="cpu")
    r1 = s.register_model("b", *variants["b"])
    s.register_model("c", *variants["c"])
    before = [t.clone() for t in s._model._kw.conv]
    assert s.register_model("b", *variants["b"]) == r1  # touch
    assert all(torch.equal(a, b) for a, b in zip(before, s._model._kw.conv))
    # now default is LRU -> the next admission evicts it, not b
    s.register_model("d", *variants["d"])
    assert DEFAULT_MODEL not in dict(s.models)
    assert dict(s.models).keys() == {"b", "c", "d"}
    with pytest.raises(KeyError):  # default evicted: unbound joins fail
        s.add_stream()


def test_single_model_scheduler_rejects_tenancy(pspec, variants):
    w0, t0 = variants[DEFAULT_MODEL]
    s = StreamScheduler(pspec, w0, t0, capacity=4, device="cpu")
    with pytest.raises(ValueError, match="max_models"):
        s.register_model("b", *variants["b"])
    with pytest.raises(ValueError, match="tenant pool"):
        s.add_stream(model="b")
    assert s.models == [(DEFAULT_MODEL, 0)]
    with pytest.raises(ValueError, match="power of two"):
        StreamScheduler(pspec, w0, t0, max_models=2, tenant_block=3,
                        device="cpu")


def test_pooled_scheduler_needs_cuda_or_cpu(pspec, variants):
    """``max_models > 1`` runs on the card unless ``device="cpu"`` is
    passed, and raises where there is no card."""
    w0, t0 = variants[DEFAULT_MODEL]
    if torch.cuda.is_available():
        s = StreamScheduler(pspec, w0, t0, max_models=4)
        assert s.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamScheduler(pspec, w0, t0, max_models=4)


def test_weight_pool_unit(variants):
    """Rows stay stable while referenced; eviction is LRU among
    refcount-0 variants only."""
    pool = WeightPool(2)
    assert pool.admit("a", *variants[DEFAULT_MODEL]) == (0, None)
    assert pool.admit("b", *variants["b"]) == (1, None)
    pool.acquire("b")
    assert pool.admit("c", *variants["c"]) == (0, "a")  # a: LRU, unpinned
    pool.release("b")
    assert pool.refcount("b") == 0
    assert len(pool) == 2 and "a" not in pool
    assert pool.admit("b", *variants["b"]) == (1, None)  # a touch
    assert pool.admits == 3 and pool.evictions == 1
    with pytest.raises(ValueError, match="no live stream"):
        pool.release("b")
    with pytest.raises(ValueError):
        WeightPool(0)


def test_tenant_metrics_split(spec, pspec, variants):
    s = _pooled(pspec, variants, max_models=4, backend="torch", capacity=8,
                hop_frames=2)
    sids = {m: s.add_stream(model=m) for m in (None, "b", "c")}
    for j, sid in enumerate(sids.values()):
        _feed(s, sid, _clip(spec, 40 + j, 960))
    _drain(s)
    ts = s.metrics.tenant_summary()
    per = ts["per_model"]
    assert per[DEFAULT_MODEL] > 0 and per["b"] > 0 and per["c"] > 0
    assert per[DEFAULT_MODEL] == per["b"] == per["c"]  # same clip length
    assert sum(per.values()) == s.metrics.stream_hops_total
    assert ts["models_admitted"] == 3.0  # b, c, d (d idle: no hops row)
    assert {"streams", "steps", "device_dispatches_per_hop"} <= set(
        s.metrics.summary())


# ---------------------------------------------------------------------------
# A pool row reused after an eviction runs the new model
# ---------------------------------------------------------------------------

def _layouts(model, backend):
    """Every weight tensor a backend's kernels read, raw and laid out,
    by name."""
    out = {f"w{i}": w for i, w in enumerate(model._w)}
    out.update({f"thr{i}": t for i, t in enumerate(model._thr)})
    out.update({f"flip{i}": f for i, f in enumerate(model._flip)})
    out.update({f"fc_w{j}": w for j, w in enumerate(model._fc_w)})
    out.update({f"fc_thr{j}": t for j, t in enumerate(model._fc_thr)})
    out.update({f"fc_flip{j}": f for j, f in enumerate(model._fc_flip)})
    if backend == "megakernel":
        for name in ("ws", "fc_ws", "conv", "wsum", "fc"):
            out.update({f"hop.{name}{i}": t for i, t in
                        enumerate(getattr(model._kw, name))})
        out.update({f"kflip{i}": f for i, f in enumerate(model._kflip)})
    else:
        for i, cw in enumerate(model._cw):
            out.update({f"cw{i}.{n}": getattr(cw, n)
                        for n in ("w", "wp", "wn", "wf", "wsum")
                        if getattr(cw, n) is not None})
        for name in ("ws", "frag"):
            out.update({f"tail.{name}{j}": t for j, t in
                        enumerate(getattr(model._kfc_w, name))})
    return out


@pytest.mark.parametrize("backend", ("megakernel", "per_stage"))
def test_reused_row_runs_new_model(spec, pspec, variants, backend):
    """Model b takes pool row 1 and runs; its streams close; model c's
    admission evicts b and rewrites row 1.  A stream of c then gives, hop
    for hop and at its close, what a single-model scheduler of c gives,
    and every raw and laid-out copy of row 1 equals c's own layout."""
    w0, t0 = variants[DEFAULT_MODEL]
    kw = dict(capacity=8, hop_frames=2, backend=backend, device="cpu")
    s = StreamScheduler(pspec, w0, t0, max_models=2, tenant_block=2, **kw)
    clip = _clip(spec, 77, 1280)
    s.add_stream()  # pins the default model, so the LRU victim is b
    assert s.register_model("b", *variants["b"]) == 1
    sb = s.add_stream(model="b")
    _feed(s, sb, clip)
    _drain(s)
    logits_b = s.close_stream(sb).logits
    assert s.register_model("c", *variants["c"]) == 1  # evicts b
    assert [m for m, _ in s.models] == [DEFAULT_MODEL, "c"]
    single = StreamScheduler(pspec, *variants["c"], **kw)
    for name, t in _layouts(single._model, backend).items():
        assert torch.equal(_layouts(s._model, backend)[name][1], t), name
    hops, want_hops = [], []
    cases.record_hops(s, hops)
    cases.record_hops(single, want_hops)
    got_c, want_c = s.add_stream(model="c"), single.add_stream()
    _feed(s, got_c, clip)
    _feed(single, want_c, clip)
    _drain(s)
    _drain(single)
    assert len(hops) == len(want_hops) > 5
    for a, b in zip(hops, want_hops):
        np.testing.assert_array_equal(a.logits, b.logits)
    logits_c = s.close_stream(got_c).logits
    np.testing.assert_array_equal(logits_c,
                                  single.close_stream(want_c).logits)
    assert not np.array_equal(logits_b, logits_c)  # the models differ
