"""Shared inputs of the port's parity tests (``tests/test_torch_*.py``):
the reference's exported models, seeded random streamable geometries, and
spec conversion between the two packages.  Everything crosses between JAX
and PyTorch as numpy."""
import dataclasses
import functools

import jax
import numpy as np

from repro.core import cnn_spec as ref_cs
from repro.models import kws
from repro_torch.core import cnn_spec as port_cs


def port_spec(spec: ref_cs.CNN1DSpec) -> port_cs.CNN1DSpec:
    """The same spec built from the port's classes."""
    layers = tuple(
        getattr(port_cs, type(lay).__name__)(
            **{f.name: getattr(lay, f.name) for f in dataclasses.fields(lay)})
        for lay in spec.layers
    )
    return port_cs.CNN1DSpec(in_len=spec.in_len,
                             in_channels=spec.in_channels,
                             in_bits=spec.in_bits, layers=layers,
                             name=spec.name)


@functools.lru_cache(maxsize=None)
def exported(spec: ref_cs.CNN1DSpec, seed: int = 0):
    """The reference's exported model: numpy int8 ternary weights and
    (float64 thresholds, bool flips) per layer, cached per (spec, seed):
    callers must not mutate it."""
    params = kws.init_kws_params(jax.random.PRNGKey(seed), spec)
    weights, thresholds = kws.export_kws(params, spec)
    weights = {k: np.asarray(v) for k, v in weights.items()}
    thresholds = {k: (np.asarray(t), np.asarray(f))
                  for k, (t, f) in thresholds.items()}
    return weights, thresholds


def random_spec(seed: int):
    """A small random streamable spec (the generator of
    ``tests/test_megakernel.py::_random_spec``): bit-serial first layer
    with random k/stride/pad, 1-2 conv blocks with random k/pad/pool, GAP,
    binary fc, raw fc.  Returns ``(spec, hop_frames)`` or None when no
    hop_frames reaches a steady state."""
    from repro.stream.state import plan_stream

    rng = np.random.default_rng(seed)
    k0 = int(rng.integers(3, 13))
    s0 = int(rng.choice([2, 4, 8]))
    c0 = int(rng.choice([4, 8]))
    bits0 = int(rng.choice([4, 8]))
    layers = [
        ref_cs.Conv1DSpec(1, c0, k=k0, stride=s0,
                          pad=int(rng.integers(0, k0)), in_bits=bits0,
                          in_offset=1 << (bits0 - 1), name="l0"),
    ]
    cin = c0
    for j in range(int(rng.integers(1, 3))):
        k = int(rng.choice([3, 5]))
        cout = int(rng.choice([4, 8]))
        layers.append(
            ref_cs.Conv1DSpec(cin, cout, k=k, stride=1,
                              pad=int(rng.integers(0, k // 2 + 1)),
                              pool=int(rng.choice([1, 2, 2, 4])),
                              name=f"b{j + 1}")
        )
        cin = cout
    layers += [
        ref_cs.GAPSpec(cin, name="gap"),
        ref_cs.FCSpec(cin, 8, in_bits=8, name="fc1"),
        ref_cs.FCSpec(8, kws.N_CLASSES, out_raw=True, name="fc2"),
    ]
    spec = ref_cs.CNN1DSpec(in_len=int(rng.integers(500, 900)),
                            in_channels=1, in_bits=layers[0].in_bits,
                            layers=tuple(layers), name=f"rand{seed}")
    for hf in (1, 2, 3, 4, 6, 8, 12):
        try:
            plan = plan_stream(spec, hop_frames=hf)
        except ValueError:
            continue
        if spec.in_len >= plan.prime_samples + 3 * plan.hop_samples:
            return spec, hf
    return None


#: seeds of random_spec that reach a steady state (checked by the tests)
RANDOM_SEEDS = (0, 1, 2, 3)


# ---------------------------------------------------------------------------
# Scheduler parity: the same operations on reference and port schedulers
# ---------------------------------------------------------------------------

def expected_launches(port, *, emit: bool, peek: bool = False) -> dict:
    """Launches by kernel name that one hop of the port's scheduler ``port``
    (or, with ``peek``, one standalone finalization) must make: what the
    reference's ``dispatches_per_hop`` counts, per kernel."""
    from repro_torch.kernels import bnn_conv1d as bk
    from repro_torch.kernels import hop_megakernel as mk

    if port.backend == "torch":
        return {}
    if port.backend == "megakernel":
        return {mk.FINALIZE_KERNEL if peek else mk.HOP_KERNEL: 1}
    out: dict[str, int] = {}

    def add(st):
        name = bk.BITSERIAL_KERNEL if st.in_bits > 1 else bk.CONV_STEP_KERNEL
        out[name] = out.get(name, 0) + 1

    if not peek:
        for st in port.plan.convs:
            add(st)
    if peek or emit:
        for st in port.plan.convs:
            if st.flush_conv > 0:
                add(st)
        out[bk.TAIL_KERNEL] = 1
    return out


class SchedulerPair:
    """The same operations applied to reference schedulers (one per backend
    in ``ref_backends``) and a port scheduler, with every result compared
    on the spot and every hop's launches held to ``dispatches_per_hop``."""

    def __init__(self, spec, weights, thresholds, backend, emit_logits,
                 device="cpu", ref_backends=("jnp",), hop_frames=1):
        from repro.stream import StreamScheduler as RefScheduler
        from repro_torch.stream import StreamScheduler as PortScheduler

        kw = dict(capacity=8, initial_capacity=2, min_capacity=2,
                  hop_frames=hop_frames, emit_logits=emit_logits)
        self.refs = [RefScheduler(spec, weights, thresholds, backend=rb,
                                  **kw) for rb in ref_backends]
        self.port = PortScheduler(port_spec(spec), weights, thresholds,
                                  backend=backend, device=device, **kw)
        self.emit = emit_logits
        self.hops = 0
        self.launches = {}

    def add(self, sid):
        for ref in self.refs:
            assert ref.add_stream(sid) == sid
        assert self.port.add_stream(sid) == sid

    def push(self, sids, chunks):
        for ref in self.refs:
            ref.push_audio_batch(sids, chunks)
        self.port.push_audio_batch(sids, chunks)

    def step(self):
        from repro_torch.kernels import dispatch

        refs = [ref.step_batch() for ref in self.refs]
        with dispatch.counting() as launched:
            port = self.port.step_batch()
        if port is None:
            assert all(r is None for r in refs) and not launched()
            return None
        self.hops += 1
        assert launched() == expected_launches(self.port, emit=self.emit)
        assert sum(launched().values()) == \
            self.port._model.dispatches_per_hop(self.emit)
        for ref in refs:
            np.testing.assert_array_equal(port.sids, ref.sids)
            np.testing.assert_array_equal(port.frames, ref.frames)
            if self.emit:
                assert port.logits.dtype == np.int32
                np.testing.assert_array_equal(port.logits,
                                              np.asarray(ref.logits))
                np.testing.assert_allclose(port.posteriors,
                                           np.asarray(ref.posteriors),
                                           atol=1e-6, rtol=1e-5)
            else:
                assert port.logits is None and ref.logits is None
            assert [(d.stream_id, d.cls, d.frame)
                    for d in port.detections] == [
                (d.stream_id, d.cls, d.frame) for d in ref.detections]
        return port

    def peek(self, sid):
        from repro_torch.kernels import dispatch

        with dispatch.counting() as launched:
            got = self.port.peek(sid)
        for k, v in launched().items():
            self.launches[k] = self.launches.get(k, 0) + v
        for ref in self.refs:
            np.testing.assert_array_equal(got, np.asarray(ref.peek(sid)))
        return got, launched()

    def close(self, sid):
        got = self.port.close_stream(sid)
        for ref in self.refs:
            want = ref.close_stream(sid)
            np.testing.assert_array_equal(got.logits, want.logits)
            assert (got.frames, got.samples) == (want.frames, want.samples)
            assert [(d.cls, d.frame) for d in got.events] == [
                (d.cls, d.frame) for d in want.events]
            assert self.port.capacity == ref.capacity
        return got


def drive_scheduler(pair: SchedulerPair, seed: int, min_hops: int = 10
                    ) -> None:
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
    # on a hop boundary: top a primed inbox up to a whole hop
    s = pair.port._streams[live[0]]
    if not s.primed:            # a long first receptive field: prime it
        pair.push([live[0]], [rng.integers(
            0, 256, pair.port.plan.prime_samples, dtype=np.uint8)])
        while pair.step() is not None:
            pass
    assert s.primed
    pair.push([live[0]], [rng.integers(0, 256, hop - len(s.frontend) % hop,
                                       dtype=np.uint8)])
    while pair.step() is not None:
        pass
    assert len(pair.port._streams[live[0]].frontend) == 0
    _, launched = pair.peek(live[0])
    # cached emit logits, or one standalone finalization
    assert launched == ({} if pair.emit else
                        expected_launches(pair.port, emit=False, peek=True))
    assert sum(launched.values()) == (
        0 if pair.emit else pair.port._model.dispatches_per_finalize())
    for sid in (1, 3, 4):       # leave: pool shrinks back
        pair.close(sid)
        live.remove(sid)
    assert pair.port.capacity == 4  # 2 live of 8: halves once
    feed(4)
    for sid in list(live):
        pair.close(sid)
    assert pair.hops > min_hops
