"""Port parity, elastic checkpoint restore: ``repro_torch.train.checkpoint``
saves a tree sharded on a (4, 1) ``("data", "model")`` mesh and restores it
onto a (2, 2) mesh, as ``tests/test_elastic.py`` does for the reference.

Four CPU processes form a gloo world.  The saved tree holds a DTensor
sharded over "data", a replicated bfloat16 DTensor and a plain tensor;
rank 0 writes the full tensors.  Every rank restores with ``shardings``
and checks each leaf's values (its full tensor and its own shard) and its
mesh and placements; a leaf whose entry is None comes back as a plain
tensor.  Then the single-process behaviour without ``shardings``: the
same file restored to the template's devices.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import torch

from repro_torch.train import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]

_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.train import checkpoint as ckpt

rank, world, port, d, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
try:
    axes = ("data", "model")
    mesh_a = init_device_mesh("cpu", (4, 1), mesh_dim_names=axes)
    mesh_b = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    m = torch.ones((4, 8), dtype=torch.bfloat16)
    b = torch.arange(6, dtype=torch.int32)
    tree = {"w": distribute_tensor(w, mesh_a, [Shard(0), Replicate()]),
            "m": distribute_tensor(m, mesh_a, [Replicate(), Replicate()]),
            "b": b}
    path = ckpt.save(d, 3, tree, meta={"rank0": True})
    shardings = {"w": (mesh_b, (Shard(0), Shard(1))),
                 "m": (mesh_b, (Replicate(), Shard(1))), "b": None}
    step, got, meta = ckpt.restore(d, tree, shardings=shardings)
    res = {"step": step, "meta": meta, "path": str(path)}
    rw, rm = got["w"], got["m"]
    res["types"] = [type(got[k]).__name__ for k in ("w", "m", "b")]
    res["mesh"] = [list(rw.device_mesh.shape), list(rm.device_mesh.shape)]
    res["placements"] = [tuple(rw.placements) == (Shard(0), Shard(1)),
                         tuple(rm.placements) == (Replicate(), Shard(1))]
    res["w_full"] = bool(torch.equal(rw.full_tensor(), w))
    res["m_full"] = bool(torch.equal(rm.full_tensor(), m))
    res["m_dtype"] = str(rm.dtype)
    # this rank's own blocks: a 2x2 grid of (4, 4) blocks of w, and
    # half of m's columns
    r, c = mesh_b.get_coordinate()
    res["w_local"] = bool(torch.equal(rw.to_local(),
                                      w[4 * r:4 * r + 4, 4 * c:4 * c + 4]))
    res["m_local"] = bool(torch.equal(rm.to_local(), m[:, 4 * c:4 * c + 4]))
    res["b"] = bool(torch.equal(got["b"], b))
    # saving a step the ranks disagree on is refused on every rank
    try:
        ckpt.save(d, 4 + (rank == 1), tree)
        res["disagree"] = "saved"
    except ValueError as e:
        res["disagree"] = str(e)
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_elastic_reshard_across_meshes(tmp_path):
    """Saved on (4, 1), restored onto (2, 2) on every rank of a gloo world
    of 4: equal values, the asked-for mesh and placements, each rank's
    own blocks; one file, written once; unequal steps refused."""
    world, port = 4, str(_free_port())
    d, out = tmp_path / "ckpt", tmp_path / "res"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), port, str(d),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-2000:] for log in logs)
    for r in range(world):
        res = json.loads(pathlib.Path(f"{out}.{r}").read_text())
        assert res["step"] == 3 and res["meta"] == {"rank0": True}
        assert res["path"] == str(d / "step-0000000003")
        assert res["types"] == ["DTensor", "DTensor", "Tensor"]
        assert res["mesh"] == [[2, 2], [2, 2]]
        assert res["placements"] == [True, True]
        assert res["m_dtype"] == "torch.bfloat16"
        for key in ("w_full", "m_full", "w_local", "m_local", "b"):
            assert res[key], (r, key)
        assert "different steps" in res["disagree"], (r, res["disagree"])
    assert sorted(p.name for p in d.iterdir()) == ["step-0000000003"]

    # without shardings: the plain restore, on the template's devices
    template = {"w": torch.zeros(8, 8),
                "m": torch.zeros(4, 8, dtype=torch.bfloat16),
                "b": torch.zeros(6, dtype=torch.int32)}
    step, got, _ = ckpt.restore(d, template)
    assert step == 3
    assert torch.equal(got["w"], torch.arange(64.).reshape(8, 8))
    assert got["m"].dtype == torch.bfloat16 and torch.equal(
        got["m"], torch.ones(4, 8, dtype=torch.bfloat16))
    assert all(type(v) is torch.Tensor for v in got.values())
