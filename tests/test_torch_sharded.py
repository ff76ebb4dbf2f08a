"""Port parity, mesh-sharded slot pool: ``repro_torch``'s scheduler over
``make_stream_mesh(S, device="cpu")`` (the kernels' plain versions) on
the smoke spec, against the reference's single-device
``StreamScheduler(backend="jnp")``.

  * the mesh: ``make_stream_mesh``, ``dp_axes``, ``dp_size``, and the
    refusals (no card, a mesh over several cards has no one device, a
    mesh mixing cards and the CPU, capacities S does not divide);
  * the sharded model (``stream.scheduler._ShardedModel``): S launches
    of each kernel a hop, one per shard on its own rows, bit-equal to the
    unsharded model (which ``tests/test_torch_per_stage.py`` and
    ``tests/test_torch_megakernel.py`` hold against the reference), and
    ``ops.remap_slot_rows`` over shards;
  * one seeded trace (joins that grow the pool, ragged pushes, peeks off
    and on a hop boundary, closes that leave the survivors crowded on
    shard 0, so the next hop barrier migrates them and shrinks the pool)
    through S in {1, 2, 8} shards on the ``torch``, ``megakernel`` and
    ``per_stage`` backends.  Shard placement reorders a hop's rows, so
    each hop is compared sorted by sid: sids, frames, logits and
    detections bit-equal, posteriors within ``atol=1e-6, rtol=1e-5``
    (softmax computed by two libraries); peeks and ``close_stream``
    logits bit-equal.  The launches counted over each round are S times
    ``dispatches_per_hop`` per hop, and a peek's S times
    ``dispatches_per_finalize`` (or none, from the emit cache);
  * the ``AsyncStreamScheduler`` with S shards and the mid-run
    rebalance, against its own synchronous S-shard run and the reference;
  * the reference's contracts: ``tests/test_stream_sharded.py`` (full
    clip, mid-hop peek, churn with resize, capacity must divide, shard
    metrics), ``tests/test_rebalance.py`` (skewed churn rebalances and
    lifts the shrink floor, a migration carries peeks and detector state)
    and ``tests/test_multitenant.py::test_mixed_tenant_sharded`` (K = 2
    tenants on S = 2 shards).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro.stream import StreamScheduler as RefScheduler
from repro_torch.kernels import dispatch, ops
from repro_torch.launch.mesh import (
    ShardRows,
    StreamMesh,
    dp_axes,
    dp_size,
    make_stream_mesh,
)
from repro_torch.runtime.pool import next_pow2
from repro_torch.stream import (
    DEFAULT_MODEL,
    AsyncStreamScheduler,
    StreamScheduler,
)
from repro_torch.stream.state import StreamState, plan_stream

SHARDS = (1, 2, 8)
BACKENDS = ("torch", "megakernel", "per_stage")
#: the trace's pool ceiling (every S divides it) and its streams
CAP = 32
N_STREAMS = 24
#: streams that survive the trace's close wave: sid % 8 == 0, which
#: least-loaded placement put on shard 0 at S = 2 and at S = 8
SURVIVORS = (0, 8, 16)


@pytest.fixture(scope="module")
def smoke():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    return spec, cases.port_spec(spec), weights, thresholds


def _mesh(n):
    return make_stream_mesh(n, device="cpu")


def _port(smoke, S, backend="megakernel", cls=StreamScheduler, **kw):
    _, pspec, weights, thresholds = smoke
    if cls is AsyncStreamScheduler:
        kw.setdefault("use_pump", False)
    return cls(pspec, weights, thresholds, backend=backend, mesh=_mesh(S),
               **kw)


def _clip(spec, seed, n=None):
    return np.random.default_rng(seed).integers(
        0, 256, (n or spec.in_len,)).astype(np.uint8)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_make_stream_mesh(S):
    mesh = _mesh(S)
    assert mesh.devices == (torch.device("cpu"),) * S
    assert mesh.axis_names == ("data",) and dp_axes(mesh) == ("data",)
    assert dp_size(mesh) == S and mesh.device == torch.device("cpu")


def test_make_stream_mesh_refusals():
    with pytest.raises(ValueError):
        make_stream_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_stream_mesh(2)
    two = StreamMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    assert dp_size(two) == 2 and two.distinct == two.devices
    with pytest.raises(ValueError, match="no single device"):
        two.device
    with pytest.raises(ValueError, match="mixes device types"):
        StreamMesh((torch.device("cuda", 0), torch.device("cpu")))
    with pytest.raises(ValueError, match="cards"):
        make_stream_mesh(2, device="cpu", cards=2)


def test_scheduler_takes_the_mesh_device(smoke):
    s = _port(smoke, 2, capacity=8)
    assert s.device.type == "cpu" and s.n_shards == 2
    with pytest.raises(ValueError, match="mesh's device"):
        _port(smoke, 2, capacity=8, device="cuda")


@pytest.mark.parametrize("kw", [dict(capacity=3),
                                dict(capacity=8, initial_capacity=3),
                                dict(capacity=8, min_capacity=3)])
def test_sharded_capacity_must_divide(smoke, kw):
    """The reference refuses a capacity its mesh does not divide
    (``tests/test_stream_sharded.py::test_sharded_capacity_must_divide``);
    the port refuses every capacity argument so."""
    with pytest.raises(ValueError, match="multiple"):
        _port(smoke, 2, **kw)


# ---------------------------------------------------------------------------
# Sharded entry points: S launches of the unsharded kernel, bit-equal
# ---------------------------------------------------------------------------

def _hop_operands(plan, b, seed, pooled=False):
    rng = np.random.default_rng(seed)
    geoms = plan.convs
    t = lambda *s: torch.as_tensor(  # noqa: E731
        rng.integers(0, 2, s, dtype=np.int32))
    audio = torch.as_tensor(rng.integers(0, 256, (b, plan.hop_samples, 1),
                                         dtype=np.int32))
    tails = tuple(torch.as_tensor(rng.integers(
        0, 256 if g.in_bits > 1 else 2, (b, g.tail, g.cin), dtype=np.int32))
        for g in geoms)
    pendings = tuple(t(b, g.phase, g.cout) for g in geoms)
    gap = torch.as_tensor(rng.integers(0, 200, (b, plan.gap_channels),
                                       dtype=np.int32))
    mask = torch.as_tensor(rng.random(b) < 0.8)
    midx = None
    if pooled:
        # tenant blocks of 2, a different pattern on every shard
        midx = torch.as_tensor(np.repeat(rng.permutation(b // 2) % 2,
                                         2).astype(np.int32))
    return audio, mask, tails, pendings, gap, midx


@pytest.mark.parametrize("S", (2, 4))
@pytest.mark.parametrize("pooled", (False, True))
def test_sharded_entry_points_equal_unsharded(smoke, S, pooled):
    """The sharded model over S shards (``_ShardedModel``, one
    ``_BatchedModel`` per device run on each shard's own rows) makes S
    launches of each kernel of a hop and of a finalize, S times the
    per-shard figure, and equals the unsharded model bit for bit, on every
    backend, emit and steady; the hop writes each shard's state into its
    part of ``out`` in place."""
    _, pspec, weights, thresholds = smoke
    plan = plan_stream(pspec, hop_frames=1)
    other = cases.exported(ref_kws.build_kws_smoke_spec(), 7)
    models = [(weights, thresholds)] + ([other] if pooled else [])
    b = 16
    audio, mask, tails, pendings, gap, midx = _hop_operands(
        plan, b, 3 + S, pooled)
    mesh = _mesh(S)
    split = lambda x: None if x is None else mesh.split(x)  # noqa: E731
    args = (audio, mask, tails, pendings, gap, midx)
    sharded = (split(audio), split(mask), [split(t) for t in tails],
               [split(p) for p in pendings], split(gap), split(midx))
    for backend in BACKENDS:
        one = _model(plan, models, backend)
        many = _model(plan, models, backend, mesh)
        for emit in (True, False):
            want = one.step(*args, emit=emit)
            with dispatch.counting() as launched:
                got = many.step(*sharded, emit=emit)
            assert sum(launched().values()) == \
                S * one.dispatches_per_hop(emit)
            _same_state(got, want)
        with dispatch.counting() as launched:
            got = many.finalize(*sharded[2:])
        assert sum(launched().values()) == S * one.dispatches_per_finalize()
        _same_state(got, one.finalize(*args[2:]))
    out = ([t.map(lambda x: torch.full_like(x, -1)) for t in sharded[2]],
           [p.map(lambda x: torch.full_like(x, -1)) for p in sharded[3]],
           sharded[4].map(lambda x: torch.full_like(x, -1)))
    many = _model(plan, models, "megakernel", mesh)
    with dispatch.counting() as launched:
        got = many.step(*sharded, emit=True, out=out)
    assert launched() == {"hop_megakernel": S}
    for g, o in zip([*got[0], *got[1], got[2]], [*out[0], *out[1], out[2]]):
        if o.shape[1]:   # zero-width state never enters the kernel
            assert all(x is y for x, y in zip(g.parts, o.parts))
    _same_state(got, _model(plan, models, "megakernel").step(*args,
                                                              emit=True))


def test_sharded_entry_points_refuse_ragged_batches(smoke):
    """A batch S does not divide is refused where it is split into the
    shards' rows."""
    _, pspec, _, _ = smoke
    plan = plan_stream(pspec, hop_frames=1)
    with pytest.raises(ValueError, match="4 shards"):
        _mesh(4).split(torch.zeros((6, plan.gap_channels)))
    with pytest.raises(ValueError, match="4 shards"):
        _mesh(4).zeros((6, plan.gap_channels))


def test_remap_slot_rows(smoke):
    """``remap_slot_rows`` is the reference's device half of a migration:
    ``out[i] = x[perm[i]]`` where ``keep[i]``, else zero rows; over shards
    each destination shard's rows are built as its own tensor, the rows
    that cross shards included."""
    x = torch.arange(24, dtype=torch.int32).reshape(6, 2, 2)
    perm = np.array([3, 1, 2, 0, 4, 5])
    keep = np.array([True, True, False, True, False, True])
    want = x[torch.as_tensor(perm)] * torch.as_tensor(keep)[:, None, None]
    assert torch.equal(ops.remap_slot_rows(x, perm, keep), want)
    xs = _mesh(2).split(x)
    got = ops.remap_slot_rows(xs, perm, keep)
    assert isinstance(got, ShardRows) and len(got.parts) == 2
    assert torch.equal(got.cpu(), want)
    assert all(g.data_ptr() != p.data_ptr()
               for g in got.parts for p in xs.parts)


def _model(plan, models, backend, mesh=None):
    """A ``_BatchedModel`` of one model, or of a pool of the given ones
    (tenant blocks of 2); over ``mesh``'s shards a ``_ShardedModel``."""
    from repro_torch.stream.scheduler import (
        _BatchedModel,
        _ShardedModel,
        prepared_model_params,
    )
    params = [prepared_model_params(plan, w, t, "cpu") for w, t in models]
    pool = dict(pool_size=len(models), tenant_block=2) \
        if len(models) > 1 else {}
    if mesh is None:
        m = _BatchedModel(plan, backend, params[0], **pool)
    else:
        m = _ShardedModel(plan, backend, lambda d: params[0], mesh, **pool)
    for row, p in enumerate(params[1:], 1):
        m.set_model_row(row, p if mesh is None else lambda d, p=p: p)
    return m


def _same_state(got, want):
    """Equal hop (or finalize) results, leaf by leaf; a sharded result's
    ``ShardRows`` are read in pool order."""
    def flat(r):
        if isinstance(r, (tuple, list)):
            return [x for part in r for x in flat(part)]
        return [r]

    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# The seeded trace: S shards against the reference's single device
# ---------------------------------------------------------------------------

class Trace:
    """Runs the seeded trace on one scheduler and records what a caller
    sees: every folded hop, the peeks, the closes, and the launches of
    each round and each peek (none on the reference)."""

    def __init__(self, sched):
        self.sched = sched
        self.hops = []
        cases.record_hops(sched, self.hops)
        self.peeks, self.closes, self.rounds, self.peek_launches = \
            [], [], [], []

    def run(self):
        s = self.sched
        rng = np.random.default_rng(11)
        hop = s.plan.hop_samples
        live = []

        def join(sids):
            for sid in sids:
                assert s.add_stream(sid) == sid
                live.append(sid)

        def feed(rounds):
            for _ in range(rounds):
                sids = [j for j in live if rng.random() < 0.85]
                s.push_audio_batch(sids, [
                    rng.integers(0, 256, int(rng.integers(1, 3 * hop)),
                                 dtype=np.uint8) for _ in sids])
                self.round()

        def peek(sid):
            with dispatch.counting() as launched:
                self.peeks.append((sid, np.asarray(s.peek(sid))))
            self.peek_launches.append(launched())

        join(range(12))
        feed(4)
        join(range(12, N_STREAMS))          # the pool grows
        feed(4)
        for sid in live:                    # off a hop boundary
            peek(sid)
        st = s._streams[0]
        if not st.primed:
            s.push_audio(0, rng.integers(0, 256, s.plan.prime_samples,
                                         dtype=np.uint8))
            self.round()
        s.push_audio(0, rng.integers(0, 256, hop - len(st.frontend) % hop,
                                     dtype=np.uint8))
        self.round()
        assert len(s._streams[0].frontend) == 0
        peek(0)                             # on a hop boundary
        for sid in [j for j in live if j not in SURVIVORS]:
            self.close(sid)                 # survivors crowd shard 0
            live.remove(sid)
        feed(3)                             # the barrier migrates them
        for sid in SURVIVORS:
            peek(sid)
        for sid in SURVIVORS:
            self.close(sid)
        if hasattr(s, "shutdown"):
            assert s.in_flight == 0
            s.shutdown()
        return self

    def round(self):
        """Two steps and a drain (the async plane dispatches ahead on the
        steps; drain retires every hop)."""
        n0 = len(self.hops)
        with dispatch.counting() as launched:
            self.sched.step_batch()
            self.sched.step_batch()
            self.sched.drain()
        self.rounds.append((len(self.hops) - n0, launched()))

    def close(self, sid):
        r = self.sched.close_stream(sid)
        self.closes.append((sid, np.asarray(r.logits), r.frames, r.samples,
                            [(d.cls, d.frame) for d in r.events]))


def _sorted_hops(hops):
    out = []
    for h in hops:
        order = np.argsort(h.sids, kind="stable")
        out.append((h.sids[order], h.frames[order],
                    None if h.logits is None else np.asarray(h.logits)[order],
                    None if h.posteriors is None
                    else np.asarray(h.posteriors)[order],
                    sorted((d.stream_id, d.cls, d.frame)
                           for d in h.detections)))
    return out


def record(trace: Trace):
    """What ``same_trace`` compares of a run, as numpy and plain python:
    the hops sorted by sid, the peeks and the closes."""
    return _sorted_hops(trace.hops), trace.peeks, trace.closes


def same_trace(got: Trace, want: Trace, exact_post: bool) -> None:
    same_record(record(got), record(want), exact_post)


def same_record(got, want, exact_post: bool) -> None:
    """Two runs' :func:`record` equal: sids, frames, logits and detections
    bit-equal, posteriors too with ``exact_post``, else within
    ``atol=1e-6, rtol=1e-5``; peeks and closes bit-equal."""
    (a, got_peeks, got_closes), (b, want_peeks, want_closes) = got, want
    assert len(a) == len(b), "hop counts differ"
    for (s1, f1, l1, p1, d1), (s2, f2, l2, p2, d2) in zip(a, b):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(f1, f2)
        assert (l1 is None) == (l2 is None)
        if l1 is not None:
            assert l1.dtype == np.int32
            np.testing.assert_array_equal(l1, l2)
            if exact_post:
                np.testing.assert_array_equal(p1, p2)
            else:
                np.testing.assert_allclose(p1, p2, atol=1e-6, rtol=1e-5)
        assert d1 == d2
    assert [s for s, _ in got_peeks] == [s for s, _ in want_peeks]
    for (_, x), (_, y) in zip(got_peeks, want_peeks):
        np.testing.assert_array_equal(x, y)
    assert len(got_closes) == len(want_closes)
    for (s1, l1, *r1), (s2, l2, *r2) in zip(got_closes, want_closes):
        assert s1 == s2 and r1 == r2
        np.testing.assert_array_equal(l1, l2)


@pytest.fixture(scope="module")
def reference(smoke):
    """The reference's single-device ``jnp`` scheduler through the trace,
    pinned at the ceiling (one compile), with emit on and off."""
    spec, _, weights, thresholds = smoke
    runs = {}
    for emit in (True, False):
        ref = RefScheduler(spec, weights, thresholds, capacity=CAP,
                           initial_capacity=CAP, min_capacity=CAP,
                           backend="jnp", emit_logits=emit)
        runs[emit] = Trace(ref).run()
    return runs


def _port_trace(smoke, S, backend, cls=StreamScheduler, emit=True,
                watch=None, **kw):
    """The trace through the port over S shards; ``watch(sched)`` is
    called on the scheduler before the trace runs."""
    sched = _port(smoke, S, backend, cls=cls, capacity=CAP,
                  initial_capacity=2 * S, min_capacity=S, emit_logits=emit,
                  **kw)
    if watch is not None:
        watch(sched)
    trace = Trace(sched).run()
    _check_launches(trace, S, emit)
    if S > 1:
        # the close wave left the survivors on shard 0: the next hop
        # barrier migrated them and the pool shrank behind the migration
        m = sched.metrics
        assert m.rebalances >= 1 and m.rows_migrated >= 1
        assert sched.obs.events.counts().get("rebalance", 0) >= 1
        caps = [c for _, c in m.capacity_events]
        assert max(caps) == CAP and caps[-1] < CAP
    return trace


def _check_launches(trace, S, emit):
    """Every round's launches are S x ``dispatches_per_hop`` per hop, by
    kernel; a peek's are none (emit cache or numpy fallback) or S x
    ``dispatches_per_finalize``; the metrics carry both figures."""
    sched = trace.sched
    model = sched._model
    for n_hops, launched in trace.rounds:
        per_hop = cases.expected_launches(sched, emit=emit)
        assert launched == {k: S * v * n_hops for k, v in per_hop.items()
                            if n_hops}
        assert sum(launched.values()) == S * n_hops * \
            model.dispatches_per_hop(emit)
    fin = {k: S * v for k, v in cases.expected_launches(
        sched, emit=False, peek=True).items()}
    for launched in trace.peek_launches:
        assert launched in ({}, fin)
        assert sum(launched.values()) in (
            0, S * model.dispatches_per_finalize())
    if sched.backend != "torch" and not emit:
        assert fin in trace.peek_launches  # a finalize ran on a peek
    summ = sched.metrics.summary()
    assert summ["device_launches_total"] == \
        S * summ["device_dispatches_total"]
    assert summ["device_launches_per_hop"] == S * model.dispatches_per_hop(
        emit)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_scheduler_matches_reference(smoke, reference, backend, S):
    same_trace(_port_trace(smoke, S, backend), reference[True],
               exact_post=False)


@pytest.mark.parametrize("backend", ("megakernel", "per_stage"))
def test_sharded_emit_off_matches_reference(smoke, reference, backend):
    """Emit off: a hop-boundary peek runs the finalization, one launch set
    per shard."""
    same_trace(_port_trace(smoke, 2, backend, emit=False),
               reference[False], exact_post=False)


@pytest.mark.parametrize("S,backend,pump", [(2, "megakernel", False),
                                            (8, "megakernel", True),
                                            (2, "per_stage", False),
                                            (8, "torch", False)])
def test_async_sharded_matches_sync_and_reference(smoke, reference, S,
                                                  backend, pump):
    """The async plane over S shards (donated state, the rebalance behind
    an epoch barrier) equals its own synchronous S-shard run hop for hop,
    posteriors included, and the reference's single-device run."""
    got = _port_trace(smoke, S, backend, cls=AsyncStreamScheduler,
                      use_pump=pump)
    sync = _port_trace(smoke, S, backend)
    same_trace(got, sync, exact_post=True)
    same_trace(got, reference[True], exact_post=False)
    if backend == "megakernel":
        assert got.sched._donate


def test_reference_mesh_scheduler_matches(smoke):
    """Against the reference's own 2-shard mesh scheduler, where the host
    has two devices (the reference's multi-device leg); skips on one."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 devices (XLA_FLAGS="
                    "--xla_force_host_platform_device_count=2)")
    from repro.launch.mesh import make_stream_mesh as ref_mesh
    spec, _, weights, thresholds = smoke
    ref = RefScheduler(spec, weights, thresholds, capacity=CAP,
                       initial_capacity=4, min_capacity=2, backend="jnp",
                       mesh=ref_mesh(2))
    same_trace(_port_trace(smoke, 2, "megakernel"),
               Trace(ref).run(), exact_post=False)


# ---------------------------------------------------------------------------
# The reference's sharded-pool contracts
# ---------------------------------------------------------------------------

def _oracle(smoke, clip, hop_frames=1):
    """The numpy ``StreamState`` fed ``clip`` and flushed."""
    _, pspec, weights, thresholds = smoke
    st = StreamState(plan_stream(pspec, hop_frames=hop_frames), weights,
                     thresholds)
    st.advance(clip, flush=True)
    return st.logits()


def _by_sid(outs):
    d = {}
    for sid, frame, logits, _ in outs:
        d.setdefault(sid, []).append((frame, None if logits is None
                                      else np.asarray(logits)))
    return d


def _same_outs(a, b, stage=""):
    da, db = _by_sid(a), _by_sid(b)
    assert da.keys() == db.keys(), stage
    for sid in da:
        assert len(da[sid]) == len(db[sid]), (stage, sid)
        for (fa, la), (fb, lb) in zip(da[sid], db[sid]):
            assert fa == fb, (stage, sid)
            np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_full_clip_and_hop_logits(smoke, S):
    """``test_sharded_full_clip_and_hop_logits_bitexact``: the same clips
    through S shards and one device give every hop's logits and every
    close equal, and each close equals the flushed numpy oracle."""
    spec = smoke[0]
    n = 2 * S
    clips = {j: _clip(spec, 300 + j) for j in range(n)}
    one = StreamScheduler(*smoke[1:], capacity=n, device="cpu")
    sh = _port(smoke, S, capacity=n)
    for s in (one, sh):
        for j in range(n):
            assert s.add_stream() == j
            s.push_audio(j, clips[j])
    _same_outs(one.run_until_starved(), sh.run_until_starved())
    for j in range(n):
        a, b = one.close_stream(j), sh.close_stream(j)
        np.testing.assert_array_equal(a.logits, b.logits)
        np.testing.assert_array_equal(b.logits, _oracle(smoke, clips[j]))


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_mid_hop_peek(smoke, S):
    """``test_sharded_mid_hop_peek_bitexact``: a peek with leftover
    sub-hop samples (numpy fallback) equals the offline prefix, and after
    draining to a hop boundary the last hop's logits and the peek agree
    with one device."""
    spec = smoke[0]
    x = _clip(spec, 310)
    prefix = 520
    peeks = {}
    for label, S_ in (("one", None), ("sharded", S)):
        s = (StreamScheduler(*smoke[1:], capacity=S, device="cpu")
             if S_ is None else _port(smoke, S, capacity=S))
        sid = s.add_stream()
        s.push_audio(sid, x[:prefix])
        s.run_until_starved()
        assert len(s._streams[sid].frontend) > 0
        peeks[label] = s.peek(sid)
        s.push_audio(sid, x[prefix:])
        outs = s.run_until_starved()
        assert len(s._streams[sid].frontend) < s.plan.hop_samples
        peeks[label + "_hop"] = (outs[-1][2], s.peek(sid))
    np.testing.assert_array_equal(peeks["one"], _oracle(smoke, x[:prefix]))
    np.testing.assert_array_equal(peeks["sharded"], peeks["one"])
    for a, b in zip(peeks["one_hop"], peeks["sharded_hop"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_churn_and_resize(smoke, S):
    """``test_sharded_churn_and_resize_bitexact``: join/leave churn across
    grow and shrink; the elastic S-shard pool resizes per shard and emits
    what a pinned one-device pool emits."""
    spec = smoke[0]
    n = 4 * S
    clips = {j: _clip(spec, 330 + j) for j in range(n)}
    el = _port(smoke, S, capacity=n)
    fx = StreamScheduler(*smoke[1:], capacity=n, initial_capacity=n,
                         min_capacity=n, device="cpu")
    assert el.capacity == 2 * S and el.shard_capacity == 2

    def lockstep(stage):
        _same_outs(el.run_until_starved(), fx.run_until_starved(), stage)

    half = n // 2
    for s in (el, fx):
        for j in range(half):
            assert s.add_stream() == j
            s.push_audio(j, clips[j][:400])
    lockstep("warm")
    assert el.capacity == 2 * S
    for s in (el, fx):
        for j in range(half, n):
            assert s.add_stream() == j
            s.push_audio(j, clips[j])
        for j in range(half):
            s.push_audio(j, clips[j][400:])
    lockstep("grow")
    assert el.capacity == n and el.shard_capacity == 4
    survivors = list(range(n - max(1, S // 2), n))
    for s in (el, fx):
        for j in range(n):
            if j not in survivors:
                np.testing.assert_array_equal(s.close_stream(j).logits,
                                              _oracle(smoke, clips[j]))
    assert el.capacity < n
    lockstep("shrink")
    for j in survivors:
        a, b = el.close_stream(j), fx.close_stream(j)
        np.testing.assert_array_equal(a.logits, b.logits)
    caps = [c for _, c in el.metrics.capacity_events]
    assert any(c == n for c in caps) and caps[-1] < n


@pytest.mark.parametrize("S", (2, 8))
def test_shard_metrics_cover_all_shards(smoke, S):
    spec = smoke[0]
    s = _port(smoke, S, capacity=2 * S)
    for j in range(S):
        s.add_stream()
        s.push_audio(j, _clip(spec, 360 + j)[:s.plan.prime_samples
                                             + 2 * s.plan.hop_samples])
    s.run_until_starved()
    ss = s.metrics.shard_summary()
    assert ss["n_shards"] == S
    assert all(p["stream_hops"] == 2 for p in ss["per_shard"])
    assert ss["imbalance"] == pytest.approx(1.0)
    assert ss["fleet_stream_hops"] == 2 * S
    # the join events name each stream's shard: one stream per shard
    joins = [e for e in s.obs.events.tail() if e["event"] == "join"]
    assert sorted(e["shard"] for e in joins) == list(range(S))


def test_empty_pool_shrinks_to_min_capacity_sharded(smoke):
    s = _port(smoke, 2, capacity=16, initial_capacity=16, min_capacity=2)
    for sid in [s.add_stream() for _ in range(16)]:
        s.close_stream(sid)
    assert s.capacity == 2


@pytest.mark.parametrize("S", (2, 8))
def test_skewed_churn_rebalance_lifts_shrink_floor(smoke, S):
    """``test_skewed_churn_rebalance_lifts_shrink_floor``: leaves skewed
    onto shard 0; the rebalanced pool reaches <= 2 * next_pow2(ceil(
    active / S)) * S, the pool without rebalance stays pinned (at S >= 4
    at the ceiling), and hops and closes equal one device's through every
    migration."""
    spec = smoke[0]
    total = 16 if S == 2 else 4 * S
    n_keep = 2 if S == 2 else 4
    clips = {j: _clip(spec, 500 + j) for j in range(total)}
    kw = dict(capacity=total, initial_capacity=total, min_capacity=S)
    reb = _port(smoke, S, **kw)
    pin = _port(smoke, S, rebalance_threshold=None, **kw)
    one = StreamScheduler(*smoke[1:], capacity=total,
                          initial_capacity=total, min_capacity=total,
                          device="cpu")
    scheds = (reb, pin, one)
    cut = reb.plan.prime_samples + 2 * reb.plan.hop_samples
    for s in scheds:
        for j in range(total):
            assert s.add_stream() == j
            s.push_audio(j, clips[j][:cut])
    outs = [s.run_until_starved() for s in scheds]
    _same_outs(outs[0], outs[2], "warm reb")
    _same_outs(outs[1], outs[2], "warm pin")
    shard0 = [j for j in range(total)
              if reb._streams[j].slot < reb.shard_capacity]
    assert [pin._streams[j].slot for j in shard0] == \
        [reb._streams[j].slot for j in shard0]
    survivors = shard0[:n_keep]
    for s in scheds:
        for j in range(total):
            if j not in survivors:
                np.testing.assert_array_equal(
                    s.close_stream(j).logits, _oracle(smoke, clips[j][:cut]))
    for s in scheds:
        for j in survivors:
            s.push_audio(j, clips[j][cut:])
    outs = [s.run_until_starved() for s in scheds]
    _same_outs(outs[0], outs[2], "post-migration reb")
    _same_outs(outs[1], outs[2], "post-migration pin")
    floor = S * next_pow2(-(-n_keep // S))
    assert reb.capacity <= 2 * floor
    assert reb.metrics.rebalances >= 1 and reb.metrics.rows_migrated >= 1
    occ = reb._slots.placement.occupancy()
    assert max(occ) - min(occ) <= 1
    assert pin.metrics.rebalances == 0 and pin.capacity >= reb.capacity
    if S >= 4:
        assert pin.capacity == total and reb.capacity < pin.capacity
    for j in survivors:
        a, b, c = (s.close_stream(j).logits for s in scheds)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(a, _oracle(smoke, clips[j]))


@pytest.mark.parametrize("S", (2, 8))
def test_rebalance_carries_peek_and_detector_state(smoke, S):
    """``test_rebalance_mid_stream_peek_and_detector_state``: a migration
    carries inbox, detector and stamp state with the stream; peeks right
    after it equal the full-clip oracle, and so do the closes."""
    spec = smoke[0]
    total = 4 * S
    clips = {j: _clip(spec, 600 + j) for j in range(total)}
    s = _port(smoke, S, capacity=total, initial_capacity=total,
              min_capacity=S)
    for j in range(total):
        s.add_stream()
        s.push_audio(j, clips[j])
    s.run_until_starved()
    keep = [j for j in range(total)
            if s._streams[j].slot < s.shard_capacity][:2]
    events = {j: list(s._streams[j].events) for j in keep}
    for j in range(total):
        if j not in keep:
            s.close_stream(j)
    assert len({s._streams[j].slot // s.shard_capacity for j in keep}) == 1
    s.run_until_starved()   # hop boundary: the migration runs, no audio
    assert s.metrics.rebalances >= 1
    assert len({s._streams[j].slot // s.shard_capacity for j in keep}) == 2
    for j in keep:
        np.testing.assert_array_equal(s.peek(j), _oracle(smoke, clips[j]))
        r = s.close_stream(j)
        np.testing.assert_array_equal(r.logits, _oracle(smoke, clips[j]))
        assert r.events[:len(events[j])] == events[j]


def test_mixed_tenant_sharded(smoke):
    """``tests/test_multitenant.py::test_mixed_tenant_sharded``: K = 2
    tenants on S = 2 shards in blocks of 2; every hop equals the
    reference's single-device pooled scheduler sorted by sid, every close
    the reference's, and each close a single-model scheduler of its
    tenant fed alike; a hop makes S launches."""
    spec, pspec, w0, t0 = smoke
    other = cases.exported(spec, 7)
    rng = np.random.default_rng(21)
    binding = [int(rng.integers(0, 2)) for _ in range(10)]
    clips = [_clip(spec, 700 + i, 480 + 160 * int(rng.integers(0, 4)))
             for i in range(10)]
    kw = dict(capacity=16, hop_frames=2, max_models=2, tenant_block=2)
    port = StreamScheduler(pspec, w0, t0, mesh=_mesh(2), **kw)
    ref = RefScheduler(spec, w0, t0, backend="jnp", **kw)
    hops = {}
    for name, s in (("port", port), ("ref", ref)):
        s.register_model("b", *other)
        hops[name] = []
        cases.record_hops(s, hops[name])
    results = {}
    for name, s in (("port", port), ("ref", ref)):
        model = lambda i: "b" if binding[i] else None  # noqa: E731
        for i in range(6):
            assert s.add_stream(i, model=model(i)) == i
            s.push_audio(i, clips[i][:len(clips[i]) // 2])
        with dispatch.counting() as launched:
            n = s.drain()
        if s is port:
            assert launched() == {"hop_megakernel": 2 * n} and n > 0
        closed = {i: s.close_stream(i).logits for i in (0, 3)}
        for i in range(6, 10):
            s.add_stream(i, model=model(i))
            s.push_audio(i, clips[i])
        for i in (1, 2, 4, 5):
            s.push_audio(i, clips[i][len(clips[i]) // 2:])
        s.drain()
        results[name] = {**closed, **{i: s.close_stream(i).logits
                                      for i in range(10) if i not in closed}}
    a, b = _sorted_hops(hops["port"]), _sorted_hops(hops["ref"])
    assert len(a) == len(b) > 3
    for x, y in zip(a, b):
        for u, v in zip(x[:3], y[:3]):
            np.testing.assert_array_equal(u, v)
        np.testing.assert_allclose(x[3], y[3], atol=1e-6, rtol=1e-5)
        assert x[4] == y[4]
    for i in range(10):
        np.testing.assert_array_equal(results["port"][i], results["ref"][i])
        w, t = (w0, t0) if binding[i] == 0 else other
        consumed = len(clips[i]) // 2 if i in (0, 3) else len(clips[i])
        one = StreamScheduler(pspec, w, t, capacity=2, hop_frames=2,
                              device="cpu")
        sid = one.add_stream()
        one.push_audio(sid, clips[i][:consumed])
        one.run_until_starved()
        np.testing.assert_array_equal(results["port"][i],
                                      one.close_stream(sid).logits)
    assert DEFAULT_MODEL in dict(port.models)
