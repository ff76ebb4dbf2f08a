"""Port parity, scheduler side: ``repro_torch``'s ``StreamScheduler`` on
the CPU (``"torch"`` and ``"megakernel"`` backends) against the
reference's ``StreamScheduler(backend="jnp")`` on the smoke spec, through
seeded ragged pushes, a join mid-run that grows the pool, closes that
shrink it, peeks on and off a hop boundary, and the final closes.

Per-hop logits, frame counts, detections and ``close_stream`` logits are
bit-equal; posteriors agree to float32 rounding (softmax is computed by
two libraries).  The launches counted per hop equal
``dispatches_per_hop`` (1 for the megakernel, 0 for the dense backend).
"""
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro.stream import StreamScheduler as RefScheduler
from repro_torch.kernels import dispatch
from repro_torch.kernels import hop_megakernel as mk
from repro_torch.stream import AsyncStreamScheduler
from repro_torch.stream import StreamScheduler as PortScheduler


@pytest.fixture(scope="module")
def smoke():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    return spec, weights, thresholds


class _Pair:
    """The same operations applied to a reference and a port scheduler,
    with every result compared on the spot."""

    def __init__(self, spec, weights, thresholds, backend, emit_logits,
                 device="cpu", reference=True):
        kw = dict(capacity=8, initial_capacity=2, min_capacity=2,
                  hop_frames=1, emit_logits=emit_logits)
        self.ref = (RefScheduler(spec, weights, thresholds, backend="jnp",
                                 **kw) if reference else None)
        self.port = PortScheduler(cases.port_spec(spec), weights, thresholds,
                                  backend=backend, device=device, **kw)
        self.emit = emit_logits
        self.hops = 0
        self.launches = {}

    def add(self, sid):
        if self.ref is not None:
            assert self.ref.add_stream(sid) == sid
        assert self.port.add_stream(sid) == sid

    def push(self, sids, chunks):
        if self.ref is not None:
            self.ref.push_audio_batch(sids, chunks)
        self.port.push_audio_batch(sids, chunks)

    def step(self):
        ref = self.ref.step_batch() if self.ref is not None else None
        with dispatch.counting() as launched:
            port = self.port.step_batch()
        if port is None:
            assert ref is None and not launched()
            return None
        self.hops += 1
        n = launched().get(mk.HOP_KERNEL, 0)
        assert n == self.port._model.dispatches_per_hop(self.emit)
        assert sum(launched().values()) == n
        if self.ref is None:
            return port
        np.testing.assert_array_equal(port.sids, ref.sids)
        np.testing.assert_array_equal(port.frames, ref.frames)
        if self.emit:
            assert port.logits.dtype == np.int32
            np.testing.assert_array_equal(port.logits, np.asarray(ref.logits))
            np.testing.assert_allclose(port.posteriors,
                                       np.asarray(ref.posteriors),
                                       atol=1e-6, rtol=1e-5)
        else:
            assert port.logits is None and ref.logits is None
        assert [(d.stream_id, d.cls, d.frame) for d in port.detections] == [
            (d.stream_id, d.cls, d.frame) for d in ref.detections]
        return port

    def peek(self, sid):
        with dispatch.counting() as launched:
            got = self.port.peek(sid)
        for k, v in launched().items():
            self.launches[k] = self.launches.get(k, 0) + v
        if self.ref is not None:
            np.testing.assert_array_equal(got, np.asarray(self.ref.peek(sid)))
        return got, launched()

    def close(self, sid):
        got = self.port.close_stream(sid)
        if self.ref is not None:
            want = self.ref.close_stream(sid)
            np.testing.assert_array_equal(got.logits, want.logits)
            assert (got.frames, got.samples) == (want.frames, want.samples)
            assert [(d.cls, d.frame) for d in got.events] == [
                (d.cls, d.frame) for d in want.events]
            assert self.port.capacity == self.ref.capacity
        return got


def _drive(pair: _Pair, seed: int) -> None:
    """The seeded script: ragged pushes, joins mid-run (pool grows 2 -> 8),
    closes (pool shrinks), peeks on and off a hop boundary."""
    rng = np.random.default_rng(seed)
    hop = pair.port.plan.hop_samples
    live = [0, 1]
    for sid in live:
        pair.add(sid)

    def feed(rounds):
        for _ in range(rounds):
            sids = [s for s in live if rng.random() < 0.85]
            chunks = [rng.integers(0, 256, int(rng.integers(1, 3 * hop)),
                                   dtype=np.uint8) for _ in sids]
            pair.push(sids, chunks)
            while pair.step() is not None:
                pass

    feed(6)
    for sid in (2, 3, 4):       # join mid-run: grows 2 -> 4 -> 8
        pair.add(sid)
        live.append(sid)
    assert pair.port.capacity == 8
    feed(6)
    # off a hop boundary: leftover sub-hop samples take the numpy fallback
    for sid in live:
        pair.peek(sid)
    # on a hop boundary: top every primed inbox up to a whole hop
    s = pair.port._streams[live[0]]
    assert s.primed
    pair.push([live[0]], [rng.integers(0, 256, hop - len(s.frontend) % hop,
                                       dtype=np.uint8)])
    while pair.step() is not None:
        pass
    assert len(pair.port._streams[live[0]].frontend) == 0
    _, launched = pair.peek(live[0])
    if pair.emit or pair.port.backend == "torch":
        assert launched == {}  # cached emit logits, or no kernel at all
    else:
        assert launched == {mk.FINALIZE_KERNEL: 1}
    for sid in (1, 3, 4):       # leave: pool shrinks back
        pair.close(sid)
        live.remove(sid)
    assert pair.port.capacity == 4  # 2 live of 8: halves once
    feed(4)
    for sid in list(live):
        pair.close(sid)
    assert pair.hops > 10


@pytest.mark.parametrize("backend,emit", [("torch", True),
                                          ("megakernel", True),
                                          ("megakernel", False)])
def test_scheduler_matches_reference(smoke, backend, emit):
    spec, weights, thresholds = smoke
    _drive(_Pair(spec, weights, thresholds, backend, emit), seed=5)


def test_default_device_is_cuda(smoke):
    spec, weights, thresholds = smoke
    if torch.cuda.is_available():
        s = PortScheduler(cases.port_spec(spec), weights, thresholds)
        assert s.device.type == "cuda" and s.backend == "megakernel"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PortScheduler(cases.port_spec(spec), weights, thresholds)


@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": object()}, "A.9"),
    ({"max_models": 2}, "A.8"),
    ({"donate_buffers": True}, "A.7"),
    ({"backend": "pallas"}, "A.6"),
])
def test_unported_features_raise(smoke, kwargs, item):
    spec, weights, thresholds = smoke
    with pytest.raises(NotImplementedError, match=item):
        PortScheduler(cases.port_spec(spec), weights, thresholds,
                      device="cpu", **kwargs)


def test_async_scheduler_raises(smoke):
    spec, weights, thresholds = smoke
    with pytest.raises(NotImplementedError, match="A.7"):
        AsyncStreamScheduler(cases.port_spec(spec), weights, thresholds)


def test_prewarm_runs_next_capacity_when_starved(smoke):
    """``prewarm=True``: a starved step runs the batched step once at the
    next pow-2 capacity, and a hop counts its launches in the metrics."""
    spec, weights, thresholds = smoke
    s = PortScheduler(cases.port_spec(spec), weights, thresholds,
                      capacity=8, initial_capacity=2, hop_frames=1,
                      prewarm=True, device="cpu")
    s.add_stream()
    assert s.step_batch() is None
    assert s.obs.events.counts().get("prewarm") == 1
    assert [sp["args"]["capacity"] for sp in s.obs.trace.spans("prewarm")
            ] == [4]
    s.push_audio(0, np.full(s.plan.prime_samples + s.plan.hop_samples, 128,
                            np.uint8))
    assert s.step_batch() is not None
    assert s.metrics.summary()["device_dispatches_total"] == 1
