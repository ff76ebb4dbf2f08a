"""Port parity, scheduler side: ``repro_torch``'s ``StreamScheduler`` on
the CPU (``"torch"`` and ``"megakernel"`` backends) against the
reference's ``StreamScheduler(backend="jnp")`` on the smoke spec, through
seeded ragged pushes, a join mid-run that grows the pool, closes that
shrink it, peeks on and off a hop boundary, and the final closes.

Per-hop logits, frame counts, detections and ``close_stream`` logits are
bit-equal; posteriors agree to float32 rounding (softmax is computed by
two libraries).  The launches counted per hop equal
``dispatches_per_hop`` (1 for the megakernel, 0 for the dense backend).
The per-stage backend's parity is in ``tests/test_torch_per_stage.py``.
"""
import numpy as np
import pytest
import torch

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro_torch.launch.mesh import StreamMesh
from repro_torch.stream import StreamScheduler as PortScheduler


@pytest.fixture(scope="module")
def smoke():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    return spec, weights, thresholds


@pytest.mark.parametrize("backend,emit", [("torch", True),
                                          ("megakernel", True),
                                          ("megakernel", False)])
def test_scheduler_matches_reference(smoke, backend, emit):
    spec, weights, thresholds = smoke
    cases.drive_scheduler(
        cases.SchedulerPair(spec, weights, thresholds, backend, emit), seed=5)


def test_default_device_is_cuda(smoke):
    spec, weights, thresholds = smoke
    if torch.cuda.is_available():
        s = PortScheduler(cases.port_spec(spec), weights, thresholds)
        assert s.device.type == "cuda" and s.backend == "megakernel"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PortScheduler(cases.port_spec(spec), weights, thresholds)


def test_mesh_over_cards_takes_shard0_device(smoke):
    """A mesh whose shards lie on two cards is taken, no longer refused
    (``tests/test_torch_multi_device.py`` runs the per-shard pool): the
    scheduler's device is shard 0's, so the CPU asked for beside it is a
    mismatch, and without a card the mesh raises the card error."""
    spec, weights, thresholds = smoke
    two = StreamMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="mesh's device"):
        PortScheduler(cases.port_spec(spec), weights, thresholds,
                      device="cpu", mesh=two)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PortScheduler(cases.port_spec(spec), weights, thresholds,
                          mesh=two)


def test_pallas_backend_name_points_to_per_stage(smoke):
    """The reference's ``backend="pallas"`` names a TPU tool: the port
    refuses it with a ``ValueError`` that names its per-stage backend."""
    spec, weights, thresholds = smoke
    with pytest.raises(ValueError, match="per_stage"):
        PortScheduler(cases.port_spec(spec), weights, thresholds,
                      device="cpu", backend="pallas")


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
