"""Port parity, the slot pool over several devices: ``repro_torch``'s
scheduler over a mesh of S >= 2 shards, each shard's rows a tensor of
their own on ``mesh.devices[s]`` (``launch.mesh.ShardRows``), against
the reference's own multi-device scheduler.

  * The reference side runs in two subprocesses that set ``XLA_FLAGS=
    --xla_force_host_platform_device_count=8`` before JAX starts (the
    pattern of ``tests/test_elastic.py``): ``repro.stream.StreamScheduler(
    backend="jnp", mesh=make_stream_mesh(S))`` on S = 2 and 8 host
    devices, through ``tests/test_torch_sharded.py``'s seeded ``Trace``
    (joins, ragged pushes, peeks off and on a hop boundary, a close wave
    that crowds shard 0 and so a rebalance), its pool pinned at the
    ceiling so that it compiles once.  Each writes its ``record``.
  * The port runs the same trace over ``make_stream_mesh(S, "cpu")`` on
    the ``torch``, ``per_stage`` and ``megakernel`` backends (the kernels'
    plain versions), sync and async, its pool elastic (grows as the
    streams join, shrinks behind the rebalance), and must equal the
    reference's run stream for stream (a slot's math never depends on the
    capacity):
    hops sorted by sid, peeks and closes bit-equal, posteriors within
    ``atol=1e-6, rtol=1e-5`` (softmax computed by two libraries).  The
    launches of every round are S times the per-shard figure and a
    rebalance and resizes happen (``_port_trace``).
  * After every resize and rebalance, and at the end, every batched state
    tensor is a ``ShardRows`` whose part ``s`` lies on ``mesh.devices[s]``
    in storage of its own; so do the staged operands, the donated spare
    set and the tenant rows.  On the CPU every shard lies on ``cpu``: the
    code is the one a multi-card machine runs, the cross-device copies
    excepted.
  * The mesh's rules: ``make_stream_mesh`` spans every visible card by
    default, ``cards`` more than are visible raise, shards split evenly
    over the cards, and a mesh mixing cards and the CPU is refused (the
    card count is patched, as no card is here).
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port_cases as cases
import test_torch_sharded as ts
from repro.models import kws as ref_kws
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import ShardRows, StreamMesh, make_stream_mesh
from repro_torch.runtime.pool import tree_map
from repro_torch.stream import AsyncStreamScheduler, StreamScheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_SHARDS = (2, 8)

_REF_RUN = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
S, out = int(sys.argv[1]), sys.argv[2]
import jax
import _torch_port_cases as cases
import test_torch_sharded as ts
from repro.launch.mesh import make_stream_mesh
from repro.models import kws
from repro.stream import StreamScheduler

assert jax.device_count() == 8
spec = kws.build_kws_smoke_spec()
weights, thresholds = cases.exported(spec)
sched = StreamScheduler(spec, weights, thresholds, capacity=ts.CAP,
                        initial_capacity=ts.CAP, min_capacity=ts.CAP,
                        backend="jnp", mesh=make_stream_mesh(S))
trace = ts.Trace(sched).run()
m = sched.metrics
with open(out, "wb") as f:
    pickle.dump({"record": ts.record(trace), "rebalances": m.rebalances,
                 "n_shards": sched.n_shards}, f)
"""


@pytest.fixture(scope="module")
def ts_smoke():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    return spec, cases.port_spec(spec), weights, thresholds


@pytest.fixture(scope="module")
def reference_mesh_runs(tmp_path_factory):
    """The reference's mesh scheduler through the trace at S = 2 and 8,
    each in its own subprocess (run side by side)."""
    d = tmp_path_factory.mktemp("ref_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        JAX_PLATFORMS="cpu")
    procs = {S: subprocess.Popen(
        [sys.executable, "-c", _REF_RUN, str(S), str(d / f"ref{S}.pkl")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for S in REF_SHARDS}
    logs = {}
    try:
        for S, p in procs.items():
            logs[S] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    runs = {}
    for S, p in procs.items():
        assert p.returncode == 0, logs[S][-3000:]
        # written by the subprocess above, from this repository's code
        with open(d / f"ref{S}.pkl", "rb") as f:
            runs[S] = pickle.load(f)
        assert runs[S]["n_shards"] == S and runs[S]["rebalances"] >= 1
    return runs


def _check_placement(sched, where):
    """Every ShardRows leaf of the scheduler's device state (and its
    spare set and tenant rows) has part ``s`` on ``mesh.devices[s]``, each
    part in storage of its own."""
    mesh = sched.mesh
    leaves = []
    tree_map(leaves.append, (sched.device_state(), sched._spare,
                             sched._model_idx_dev))
    leaves = [leaf for leaf in leaves if leaf is not None]
    seen = set()
    for leaf in leaves:
        assert isinstance(leaf, ShardRows), (where, type(leaf))
        assert leaf.devices == mesh.devices, where
        assert leaf.shape[0] == leaves[0].shape[0], where
        for p in leaf.parts:
            if p.numel():
                ptr = p.untyped_storage().data_ptr()
                assert ptr not in seen, (where, "shared storage")
                seen.add(ptr)


def _watch(checks):
    """A ``_port_trace`` hook: check the placement after every structural
    remap (``set_device_state``, which every resize and rebalance calls)
    and after every dispatched hop's staging."""
    def watch(sched):
        install = sched.set_device_state
        stage = sched._staging.to_device

        def set_device_state(state):
            install(state)
            _check_placement(sched, "remap")
            checks.append("remap")

        def to_device(i, name, a):
            got = stage(i, name, a)
            assert isinstance(got, ShardRows)
            assert got.devices == sched.mesh.devices
            checks.append(name)
            return got

        sched.set_device_state = set_device_state
        sched._staging.to_device = to_device
    return watch


@pytest.mark.parametrize("S", REF_SHARDS)
@pytest.mark.parametrize("backend", ("torch", "per_stage", "megakernel"))
@pytest.mark.parametrize("cls", (StreamScheduler, AsyncStreamScheduler),
                         ids=("sync", "async"))
def test_port_pool_matches_reference_mesh(ts_smoke, reference_mesh_runs, S,
                                          backend, cls):
    """The port's per-shard pool equals the reference's S-device
    scheduler through churn, resizes and a rebalance, every shard's
    tensors on its own device throughout."""
    checks = []
    trace = ts._port_trace(ts_smoke, S, backend, cls=cls,
                           watch=_watch(checks))
    assert checks.count("remap") >= 3 and "audio" in checks
    _check_placement(trace.sched, "end")
    if cls is AsyncStreamScheduler and backend == "megakernel":
        assert trace.sched._donate
    ts.same_record(ts.record(trace), reference_mesh_runs[S]["record"],
                   exact_post=False)


def test_tenant_pool_rows_per_shard(ts_smoke):
    """K = 2 tenants over 2 shards: the weight stacks lie once per
    distinct device, the tenant rows go to each shard's device with its
    operands, and a hop makes one launch a shard."""
    spec, pspec, w0, t0 = ts_smoke
    other = cases.exported(spec, 7)
    mesh = make_stream_mesh(2, device="cpu")
    s = StreamScheduler(pspec, w0, t0, capacity=8, max_models=2,
                        tenant_block=2, mesh=mesh)
    s.register_model("b", *other)
    assert list(s._model.models) == [torch.device("cpu")]
    rng = np.random.default_rng(5)
    for i in range(4):
        s.add_stream(i, model="b" if i % 2 else None)
        s.push_audio(i, rng.integers(0, 256, 900, dtype=np.uint8))
    with dispatch.counting() as launched:
        n = s.drain()
    assert n > 0 and launched() == {"hop_megakernel": 2 * n}
    _check_placement(s, "tenants")
    assert isinstance(s._model_idx_dev, ShardRows)
    rows = s._model_idx_dev.cpu().numpy()
    for i in range(4):
        assert rows[s._streams[i].slot] == (1 if i % 2 else 0)


def test_stream_mesh_rules(monkeypatch):
    """``make_stream_mesh`` over cards: every visible card by default
    (one shard a card), ``n_shards`` spread evenly in contiguous runs,
    ``cards`` picks the first n and more than are visible raise, an
    indexed card or the CPU holds logical shards, and cards never mix
    with the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = lambda i: torch.device("cuda", i)  # noqa: E731
    assert make_stream_mesh().devices == tuple(map(card, range(4)))
    assert make_stream_mesh(8).devices == tuple(
        card(i) for i in range(4) for _ in range(2))
    assert make_stream_mesh(cards=2).devices == (card(0), card(1))
    assert make_stream_mesh(4, cards=2).distinct == (card(0), card(1))
    assert make_stream_mesh(2, device="cuda:3").devices == (card(3),) * 2
    assert make_stream_mesh(device="cpu").devices == (torch.device("cpu"),)
    assert StreamMesh((torch.device("cuda"),)).devices == (card(0),)
    with pytest.raises(ValueError, match="5 cards, and 4 are visible"):
        make_stream_mesh(cards=5)
    with pytest.raises(ValueError, match="split evenly"):
        make_stream_mesh(6)
    with pytest.raises(ValueError, match="cards"):
        make_stream_mesh(2, device="cuda:1", cards=2)
    with pytest.raises(ValueError, match="mixes device types"):
        StreamMesh((card(0), torch.device("cpu")))
    with pytest.raises(ValueError, match="mixes device types"):
        StreamMesh((card(0), card(1), torch.device("cpu")))
