"""Port parity, async plane: ``repro_torch``'s ``AsyncStreamScheduler`` on
the CPU against its own synchronous ``StreamScheduler`` and the
reference's ``AsyncStreamScheduler(backend="jnp")``, on the smoke spec.

  * ``InFlightQueue`` (depth policy, FIFO, barrier) and ``IngestPump``
    (deferred errors at the next ``flush``, ``close``) as units;
  * the seeded interleaving property (the reference's
    ``tests/test_async.py``): random schedules of ragged pushes, hop
    steps, joins, closes, peeks and drains (through grows and shrinks) on
    the ``torch``, ``megakernel`` and ``per_stage`` backends.  Per-hop
    sids, frames, logits and detections, close logits, peeks, detector
    state and each stream's event lifecycle are bit-equal between the
    port's async and sync schedulers and the reference's async one;
    posteriors and detection scores agree with the reference within
    ``atol=1e-6, rtol=1e-5`` (softmax is computed by two libraries);
  * a pump race stress test, the arena seqlock, ``drain`` retiring
    in-flight hops and a close with a hop in flight, equal to the numpy
    ``StreamState``;
  * the trace overlap invariants under a fake clock;
  * ``donate_buffers``: exactly two state sets swap, with the results of
    it off.

pytest-timeout is not installed everywhere, so every wait on a thread
here has its own timeout and fails when it runs out.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro.obs import Observability as RefObservability
from repro.stream import AsyncStreamScheduler as RefAsync
from repro_torch.kernels import dispatch
from repro_torch.obs import Observability, coverage, overlap_stats
from repro_torch.runtime import InFlightQueue, IngestPump
from repro_torch.stream import (
    AsyncStreamScheduler,
    RingArena,
    StreamScheduler,
    StreamState,
)

#: every thread wait in this file gives up after this many seconds
WAIT_S = 60.0


@pytest.fixture(scope="module")
def smoke():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    return spec, cases.port_spec(spec), weights, thresholds


def _audio(sid: int, pos: int, n: int) -> np.ndarray:
    """Deterministic per-(sid, position) sample codes: any schedule that
    feeds stream ``sid`` its samples in order feeds identical bytes."""
    idx = np.arange(pos, pos + n, dtype=np.uint64)
    return ((idx * 2654435761 + sid * 97003) % 251).astype(np.uint8)


def _oracle(smoke, sid: int, n: int) -> np.ndarray:
    """The numpy ``StreamState`` fed stream ``sid``'s first ``n`` samples
    and flushed: the logits a close after them must give."""
    _, pspec, weights, thresholds = smoke
    from repro_torch.stream.state import plan_stream
    st = StreamState(plan_stream(pspec, hop_frames=1), weights, thresholds)
    st.advance(_audio(sid, 0, n), flush=True)
    return st.logits()


class FakeClock:
    """Monotone clock that ticks ``tick`` per read."""

    def __init__(self, tick: float = 1e-4) -> None:
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def _async(smoke, **kw):
    _, pspec, weights, thresholds = smoke
    kw.setdefault("obs", Observability.create(mirror_events=False))
    return AsyncStreamScheduler(pspec, weights, thresholds, device="cpu",
                                **kw)


# ---------------------------------------------------------------------------
# InFlightQueue and IngestPump
# ---------------------------------------------------------------------------

def test_inflight_queue_depth_fifo_barrier():
    retired = []
    q = InFlightQueue(lambda item, busy: retired.append((item, busy))
                      or item, depth=1)
    q.push("a")
    assert q.settle(dispatched=True) == [] and len(q) == 1
    q.push("b")
    assert q.settle(dispatched=True) == ["a"]   # past its depth: retire 1
    assert retired == [("a", True)]             # b still runs under a's fold
    q.push("c")
    assert q.settle(dispatched=False, max_retire=None) == ["b", "c"]
    assert retired[-1] == ("c", False) and not q
    for x in "def":
        q.push(x)
    assert q.settle(dispatched=True, max_retire=1) == ["d"]
    assert q.barrier() == ["e", "f"] and len(q) == 0
    deep = InFlightQueue(lambda item, busy: item, depth=2)
    for x in "xyz":
        deep.push(x)
    assert deep.settle(dispatched=True) == ["x"] and len(deep) == 2
    with pytest.raises(ValueError, match="depth"):
        InFlightQueue(lambda item, busy: item, depth=0)


def test_ingest_pump_error_surfaces_at_next_flush():
    landed = []

    def apply(sids, chunks):
        if sids == [-1]:
            raise KeyError("sid -1")
        landed.append((sids, chunks))

    pump = IngestPump(apply)
    pump.submit([1], ["a"])
    pump.submit([-1], ["bad"])
    pump.submit([2], ["b"])
    with pytest.raises(KeyError, match="sid -1"):
        pump.flush(timeout=WAIT_S)
    pump.flush(timeout=WAIT_S)  # consumed: the next flush is clean
    assert landed == [([1], ["a"]), ([2], ["b"])]
    assert pump.pushed_batches == 2
    pump.close(timeout=WAIT_S)
    assert not pump._thread.is_alive()


def test_ingest_pump_flush_times_out():
    gate = threading.Event()
    pump = IngestPump(lambda sids, chunks: gate.wait(WAIT_S))
    pump.submit([0], [0])
    with pytest.raises(TimeoutError, match="still queued"):
        pump.flush(timeout=0.05)
    gate.set()
    pump.close(timeout=WAIT_S)
    assert not pump._thread.is_alive()


def test_async_default_device_is_cuda(smoke):
    """Without ``device="cpu"`` the async scheduler runs on the card, and
    raises where there is none."""
    _, pspec, weights, thresholds = smoke
    if torch.cuda.is_available():
        s = AsyncStreamScheduler(pspec, weights, thresholds, use_pump=False)
        assert s.device.type == "cuda" and s._donate
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            AsyncStreamScheduler(pspec, weights, thresholds)


# ---------------------------------------------------------------------------
# Interleaving property: port async == port sync == reference async
# ---------------------------------------------------------------------------

_MAX_STREAMS = 8


def _run_schedule(smoke, kind, ops, backend):
    spec, pspec, weights, thresholds = smoke
    kwargs = dict(capacity=_MAX_STREAMS, initial_capacity=2, min_capacity=2,
                  clock=FakeClock())
    if kind == "ref":
        sched = RefAsync(spec, weights, thresholds, backend="jnp",
                         use_pump=False,
                         obs=RefObservability.create(mirror_events=False),
                         **kwargs)
    else:
        cls = AsyncStreamScheduler if kind == "async" else StreamScheduler
        if kind == "async":
            kwargs["use_pump"] = False  # deterministic landing
        sched = cls(pspec, weights, thresholds, backend=backend,
                    device="cpu",
                    obs=Observability.create(mirror_events=False), **kwargs)
    hops: list = []
    cases.record_hops(sched, hops)
    hop = sched.plan.hop_samples
    limit = min(hop * 64, sched._inbox_samples)
    fed: dict[int, int] = {}
    live: list[int] = []
    closes: dict[int, object] = {}
    peeks: list[tuple] = []
    for op in ops:
        k = op[0]
        if k == "join":
            if len(live) < _MAX_STREAMS:
                sid = sched.add_stream()
                live.append(sid)
                fed[sid] = 0
        elif k == "push" and live:
            sid = live[op[1] % len(live)]
            n = op[2] * (hop // 2 + 1)  # ragged: never a hop multiple
            if fed[sid] + n <= limit:
                sched.push_audio_batch([sid], [_audio(sid, fed[sid], n)])
                fed[sid] += n
        elif k == "step":
            sched.step_batch()
        elif k == "drain":
            sched.drain()
        elif k == "peek" and live:
            sid = live[op[1] % len(live)]
            peeks.append((sid, np.asarray(sched.peek(sid)).copy()))
        elif k == "close" and live:
            sid = live.pop(op[1] % len(live))
            closes[sid] = sched.close_stream(sid)
    sched.drain()
    digests = {sid: sched._detector.state_digest(sched._streams[sid].slot)
               for sid in live}
    for sid in list(live):
        closes[sid] = sched.close_stream(sid)
    if kind != "sync":
        assert sched.in_flight == 0
        sched.shutdown()
    return dict(hops=hops, closes=closes, peeks=peeks, fed=fed,
                digests=digests, events=sched.obs.events.tail(),
                resizes=sched.metrics.resize_count)


def _lifecycle(events, with_score: bool):
    """Per-sid ordered lifecycle (join, detection, close) and the resize
    and mass-join sequences."""
    keys = ("cls", "frame", "frames", "samples", "events") + (
        ("score",) if with_score else ())
    per_sid: dict[int, list] = {}
    for rec in events:
        if rec["event"] in ("join", "detection", "close") and "sid" in rec:
            per_sid.setdefault(rec["sid"], []).append(
                (rec["event"], tuple(sorted((k, v) for k, v in rec.items()
                                            if k in keys))))
    resizes = [(r["old"], r["new"]) for r in events if r["event"] == "resize"]
    mass = [r["n"] for r in events if r["event"] == "mass_join"]
    return per_sid, resizes, mass


def _scores(events):
    return [r["score"] for r in events if r["event"] == "detection"]


def _same_closes(a, b, exact_score: bool):
    assert a.keys() == b.keys()
    for sid in a:
        x, y = a[sid], b[sid]
        np.testing.assert_array_equal(x.logits, y.logits)
        assert (x.frames, x.samples) == (y.frames, y.samples)
        assert [(d.cls, d.frame) for d in x.events] == [
            (d.cls, d.frame) for d in y.events]
        if exact_score:
            assert [d.score for d in x.events] == [d.score for d in y.events]


def _seeded_schedule(seed: int, n_ops: int = 60) -> list[tuple]:
    rng = np.random.default_rng(seed)
    ops: list[tuple] = [("join",), ("join",)]
    kinds = ["push"] * 6 + ["step", "join", "close", "peek", "drain"]
    for _ in range(n_ops):
        k = kinds[int(rng.integers(0, len(kinds)))]
        ops.append((k, int(rng.integers(0, 64)), int(rng.integers(1, 4))))
    return ops + [("drain",)]


@pytest.mark.parametrize("backend", ("torch", "megakernel", "per_stage"))
@pytest.mark.parametrize("seed", (2, 4))
def test_interleaving_property_seeded(smoke, backend, seed):
    """Port async == port sync bit for bit, and == the reference's async
    scheduler (``jnp``) but for the posteriors' last float32 bits, through
    joins, ragged pushes, closes, peeks, a grow and a shrink."""
    ops = _seeded_schedule(seed)
    ref = _run_schedule(smoke, "ref", ops, backend)
    sync = _run_schedule(smoke, "sync", ops, backend)
    asyn = _run_schedule(smoke, "async", ops, backend)
    assert ref["fed"] == sync["fed"] == asyn["fed"]
    cases.same_hops(asyn["hops"], sync["hops"], exact_post=True)
    cases.same_hops(asyn["hops"], ref["hops"], exact_post=False)
    _same_closes(asyn["closes"], sync["closes"], exact_score=True)
    _same_closes(asyn["closes"], ref["closes"], exact_score=False)
    for (s1, p1), (s2, p2), (s3, p3) in zip(asyn["peeks"], sync["peeks"],
                                            ref["peeks"]):
        assert s1 == s2 == s3
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(p1, p3)
    assert len(asyn["peeks"]) == len(ref["peeks"])
    assert asyn["digests"] == sync["digests"]
    for sid, d in asyn["digests"].items():
        r = ref["digests"][sid]
        assert d[1:] == r[1:]
        np.testing.assert_allclose(np.frombuffer(d[0], np.float64),
                                   np.frombuffer(r[0], np.float64),
                                   atol=1e-6, rtol=1e-5)
    assert asyn["resizes"] == sync["resizes"] == ref["resizes"]
    assert _lifecycle(asyn["events"], True) == _lifecycle(sync["events"],
                                                          True)
    assert _lifecycle(asyn["events"], False) == _lifecycle(ref["events"],
                                                           False)
    np.testing.assert_allclose(_scores(asyn["events"]),
                               _scores(ref["events"]), atol=1e-6, rtol=1e-5)
    resizes = [(r["old"], r["new"]) for r in asyn["events"]
               if r["event"] == "resize"]
    assert any(n > o for o, n in resizes) and any(n < o for o, n in resizes)
    assert len(asyn["hops"]) > 10


# ---------------------------------------------------------------------------
# Race stress: producer threads vs in-flight hops
# ---------------------------------------------------------------------------

def test_ingest_pump_race_stress(smoke):
    """4 producer threads push ragged chunks through the pump while the
    main thread keeps hops in flight.  Every sample lands exactly once
    and untorn: the arena's monotone per-slot ``samples_in`` reconciles
    with what each producer pushed, the closes equal the numpy
    ``StreamState`` on the full byte stream, and lock-free seqlock readers
    never observe an inconsistent window."""
    n_threads, sids_per, chunks_per = 4, 2, 30
    n = n_threads * sids_per
    sched = _async(smoke, capacity=n, initial_capacity=n, min_capacity=n,
                   inbox_samples=8192)
    sids = [sched.add_stream() for _ in range(n)]
    pushed = {sid: 0 for sid in sids}

    def producer(t: int) -> None:
        rng = np.random.default_rng(1000 + t)
        mine = sids[t * sids_per:(t + 1) * sids_per]
        for _ in range(chunks_per):
            for sid in mine:
                k = int(rng.integers(20, 180))
                sched.push_audio_batch([sid], [_audio(sid, pushed[sid], k)])
                pushed[sid] += k  # thread-local sid: no write race

    stop = threading.Event()
    violations: list = []

    def checker() -> None:
        arena = sched._arena
        while not stop.is_set():
            wr, rd = arena.read_consistent(
                lambda: (arena.wr.copy(), arena.rd.copy()))
            fill = wr - rd
            if (fill < 0).any() or (fill > arena.capacity_samples).any():
                violations.append((wr, rd))  # torn read admitted
                return

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        chk = threading.Thread(target=checker, daemon=True)
        for th in threads:
            th.start()
        chk.start()
        deadline = time.monotonic() + WAIT_S
        while any(th.is_alive() for th in threads):
            assert time.monotonic() < deadline, "producers did not finish"
            sched.step_batch()  # keep hops in flight under the pushes
        for th in threads:
            th.join(timeout=WAIT_S)
            assert not th.is_alive()
        stop.set()
        chk.join(timeout=WAIT_S)
        assert not chk.is_alive()
    finally:
        sys.setswitchinterval(old_interval)
    sched.flush_ingest(timeout=WAIT_S)
    sched.drain()  # retires the in-flight hops
    assert not violations, "seqlock admitted a torn read"
    assert sched._arena.generation % 2 == 0  # no writer left open
    for sid in sids:
        slot = sched._streams[sid].slot
        assert int(sched._arena.samples_in[slot]) == pushed[sid], sid
    for sid in sids:
        r = sched.close_stream(sid)
        assert r.samples == pushed[sid]
        np.testing.assert_array_equal(r.logits,
                                      _oracle(smoke, sid, pushed[sid]))
    sched.shutdown(timeout=WAIT_S)
    assert sched._pump is None


def test_pump_surfaces_push_errors(smoke):
    """A pumped push to an unknown sid fails on the worker thread; the
    error surfaces at the next flush (and the pump keeps working)."""
    sched = _async(smoke, capacity=2, initial_capacity=2, min_capacity=2)
    sid = sched.add_stream()
    sched.push_audio(9999, np.zeros(8, np.uint8))  # unknown sid
    with pytest.raises(KeyError, match="9999"):
        sched.flush_ingest(timeout=WAIT_S)
    sched.push_audio(sid, _audio(sid, 0, 64))
    sched.flush_ingest(timeout=WAIT_S)
    assert int(sched._arena.samples_in[sched._streams[sid].slot]) == 64
    sched.shutdown(timeout=WAIT_S)


def test_arena_seqlock_parity():
    """Failed (validated-out) arena ops leave the generation untouched;
    successful mutations bump it by exactly 2 (odd only mid-write)."""
    arena = RingArena(2, 16)
    g0 = arena.generation
    assert g0 % 2 == 0
    with pytest.raises(MemoryError):
        arena.push(0, np.zeros(32, np.uint8))  # overflow: rejected clean
    assert arena.generation == g0
    arena.push(0, np.zeros(8, np.uint8))
    assert arena.generation == g0 + 2
    assert arena.read_consistent(lambda: arena.fill_of(0)) == 8


# ---------------------------------------------------------------------------
# drain()/close with a hop in flight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ("megakernel", "per_stage"))
def test_drain_retires_inflight_hops(smoke, backend):
    """``drain()`` flushes the pump and retires in-flight hops: after it
    nothing is unfolded and a peek equals the numpy ``StreamState``."""
    sched = _async(smoke, capacity=2, initial_capacity=2, min_capacity=2,
                   backend=backend)
    sid = sched.add_stream()
    plan = sched.plan
    total = plan.prime_samples + 5 * plan.hop_samples
    sched.push_audio(sid, _audio(sid, 0, total))
    sched.flush_ingest(timeout=WAIT_S)
    with dispatch.counting() as launched:
        sched.step_batch()  # primes + dispatches hop 1 — stays in flight
    assert sched.in_flight == 1
    assert sum(launched().values()) == sched._model.dispatches_per_hop(True)
    hops = sched.drain()
    assert sched.in_flight == 0 and hops >= 4
    np.testing.assert_array_equal(sched.peek(sid), _oracle(smoke, sid, total))
    sched.shutdown(timeout=WAIT_S)


def test_close_with_hop_in_flight_matches_state(smoke):
    """Closing a stream while its hop is in flight retires the hop, folds
    it, then runs the end-of-stream flush: equal to the numpy
    ``StreamState`` over everything pushed (a sub-hop tail included)."""
    sched = _async(smoke, capacity=2, initial_capacity=2, min_capacity=2)
    sid = sched.add_stream()
    plan = sched.plan
    total = plan.prime_samples + 3 * plan.hop_samples + 7  # ragged tail
    sched.push_audio(sid, _audio(sid, 0, total))
    sched.flush_ingest(timeout=WAIT_S)
    sched.step_batch()
    sched.step_batch()
    assert sched.in_flight >= 1  # a hop really is mid-air
    r = sched.close_stream(sid)
    assert sched.in_flight == 0
    assert r.samples == total
    np.testing.assert_array_equal(r.logits, _oracle(smoke, sid, total))
    sched.shutdown(timeout=WAIT_S)


# ---------------------------------------------------------------------------
# Trace invariants under overlap
# ---------------------------------------------------------------------------

def test_coverage_overlap_mode_synthetic():
    """Overlapping phases double count under the tile invariant but union
    coverage stays exact, and ``overlap_stats`` reports the host∩device
    overlap."""
    spans = [
        {"name": "hop", "t0": 0.0, "dur_s": 10.0},
        {"name": "pack", "t0": 0.0, "dur_s": 1.0},
        {"name": "device", "t0": 1.0, "dur_s": 8.0},
        {"name": "detector", "t0": 9.0, "dur_s": 1.0},
        {"name": "hop", "t0": 2.0, "dur_s": 12.0},
        {"name": "pack", "t0": 2.0, "dur_s": 1.0},
        {"name": "device", "t0": 3.0, "dur_s": 10.0},
        {"name": "detector", "t0": 13.0, "dur_s": 1.0},
    ]
    phases = ("pack", "device", "detector")
    assert coverage(spans, phases=phases) == pytest.approx(1.0)
    assert coverage(spans, phases=phases, mode="overlap") == pytest.approx(1.0)
    stats = overlap_stats(spans)
    assert stats["hidden"] == pytest.approx(2.0)
    assert stats["host_total"] == pytest.approx(4.0)
    assert stats["hidden_frac"] == pytest.approx(0.5)
    assert stats["utilization"] == pytest.approx(12.0 / 14.0)
    gappy = [s for s in spans if s["name"] != "device"]
    assert coverage(gappy, phases=phases, mode="overlap") < 0.5


@pytest.mark.parametrize("backend", ("megakernel", "torch"))
def test_async_trace_overlap_invariants(smoke, backend):
    """Fake-clock async run: each hop's phases still tile its own span,
    union coverage holds the 95 % floor, and the device ∩ pack(N+1)
    overlap is reported as hidden wall; the sync trace reports none."""
    _, pspec, weights, thresholds = smoke
    obs = Observability.create(mirror_events=False)
    sched = _async(smoke, capacity=4, initial_capacity=4, min_capacity=4,
                   obs=obs, clock=FakeClock(), use_pump=False,
                   inbox_samples=1 << 13, backend=backend)
    plan = sched.plan
    sids = [sched.add_stream() for _ in range(4)]
    total = plan.prime_samples + 16 * plan.hop_samples
    sched.push_audio_batch(sids, [_audio(s, 0, total) for s in sids])
    sched.drain()
    spans = obs.trace.spans()
    assert coverage(spans) >= 0.95
    assert 0.95 <= coverage(spans, mode="overlap") <= 1.0 + 1e-9
    stats = overlap_stats(spans)
    assert stats["hidden"] > 0.0 and stats["hidden_frac"] >= 0.8, stats
    assert sched.metrics.overlap_summary()["hidden_frac"] >= 0.8
    obs2 = Observability.create(mirror_events=False)
    sync = StreamScheduler(pspec, weights, thresholds, capacity=4,
                           initial_capacity=4, min_capacity=4, obs=obs2,
                           clock=FakeClock(), inbox_samples=1 << 13,
                           backend=backend, device="cpu")
    sids = [sync.add_stream() for _ in range(4)]
    sync.push_audio_batch(sids, [_audio(s, 0, total) for s in sids])
    sync.drain()
    assert sync.metrics.overlap_summary()["hidden_ms"] == 0.0
    assert coverage(obs2.trace.spans(), mode="overlap") >= 0.95


# ---------------------------------------------------------------------------
# donate_buffers: two state sets ping-pong
# ---------------------------------------------------------------------------

def _steady_run(smoke, cls, donate, n_hops=12, **kw):
    _, pspec, weights, thresholds = smoke
    sched = cls(pspec, weights, thresholds, capacity=4, initial_capacity=4,
                min_capacity=4, donate_buffers=donate, device="cpu", **kw)
    sids = [sched.add_stream() for _ in range(3)]
    plan = sched.plan
    sched.push_audio_batch(sids, [
        _audio(s, 0, plan.prime_samples + n_hops * plan.hop_samples)
        for s in sids])
    if cls is AsyncStreamScheduler:
        sched.flush_ingest(timeout=WAIT_S)
    hops: list = []
    cases.record_hops(sched, hops)
    sets: list = []
    while True:
        dispatched = sched._advance()[0] if cls is AsyncStreamScheduler \
            else sched.step_batch() is not None
        if not dispatched and not getattr(sched, "_inflight", None):
            break
        if dispatched:
            sets.append((sched._gap.data_ptr(),
                         tuple(t.data_ptr() for t in sched._tails)))
    closes = [sched.close_stream(s).logits for s in sids]
    if cls is AsyncStreamScheduler:
        sched.shutdown(timeout=WAIT_S)
    return hops, sets, closes


@pytest.mark.parametrize("cls", (StreamScheduler, AsyncStreamScheduler))
def test_donate_buffers_ping_pong(smoke, cls):
    """With ``donate_buffers`` the megakernel writes each hop's state
    into the set the previous hop read: exactly two state sets alternate
    (by data pointer), and every hop and close equals the run without
    donation, where each hop's state is new."""
    kw = {"use_pump": False} if cls is AsyncStreamScheduler else {}
    hops_d, sets_d, closes_d = _steady_run(smoke, cls, True, **kw)
    hops_n, sets_n, closes_n = _steady_run(smoke, cls, False, **kw)
    assert len(hops_d) == len(hops_n) >= 10
    cases.same_hops(hops_d, hops_n, exact_post=True)
    for a, b in zip(closes_d, closes_n):
        np.testing.assert_array_equal(a, b)
    assert len(set(sets_d)) == 2
    assert all(a != b for a, b in zip(sets_d, sets_d[1:]))
    assert all(a == b for a, b in zip(sets_d, sets_d[2:]))
    assert len(set(sets_n)) > 2


def test_donate_buffers_changes_nothing_off_megakernel(smoke):
    """On the dense and per-stage backends the flag is accepted and the
    scheduler keeps no second state set."""
    _, pspec, weights, thresholds = smoke
    for backend in ("torch", "per_stage"):
        s = StreamScheduler(pspec, weights, thresholds, backend=backend,
                            donate_buffers=True, device="cpu")
        assert not s._donate and s._spare is None
