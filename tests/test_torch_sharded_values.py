"""The dry run's sharded arithmetic on real values.

Under a sharding policy the port's model code runs on DTensors through
its own shard-local pieces (``sharding.act.shard_map`` / ``matmul`` /
``reshape``, the sharded attention, cache write, MoE, embedding and
vocab-parallel loss, the Mamba and mLSTM wrappers).  The dry run only
counts what they do on fake tensors; here they run on real ones, in a
``gloo`` world of 1 (a 1x1 mesh) and 4 processes (a 2x2 data x model
mesh) on the CPU, for the smoke configs of the dense, MoE, hybrid, SSM and
encoder-decoder families.  Each rank computes the loss and every
gradient, the prefill logits and three decode steps' logits twice: with
DTensors sharded by ``sharding.specs`` and with plain tensors under the
same policy (where every constraint is a no-op, and the MoE takes the same
grouped dispatch at the DP size).

Tolerances.  On the 1x1 mesh nothing is split, so the LM tests' hold:
loss within ``LOSS_RTOL``, each gradient leaf within ``GRAD_REL_L2``
(relative L2), logits within ``LOGIT_RTOL`` / ``LOGIT_ATOL``.  On the
2x2 mesh the row-parallel products are bf16 partial sums reduced across
ranks, so the result differs from the plain one by rounding; the bound
there is the plain run's own sensitivity: the same run with every weight
moved by one bf16 ulp (a seeded sign each) must move the gradients and
logits at least as far as sharding does (relative L2, worst leaf).  A
missing or repeated reduction shows as an O(1) error: gradients are also
held within ``SPLIT_GRAD_REL_L2`` and the loss within
``SPLIT_LOSS_RTOL`` whatever the sensitivity.  The ``fsdp`` case stores
every matrix sharded over the data axis too (``FSDP_THRESHOLD_BYTES`` 0)
and the experts expert-parallel (``GROUPED_BANK_BYTES`` 0), with the
exact dense MoE dispatch on both sides.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

ARCHS = ("qwen3-0.6b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b",
         "xlstm-350m", "seamless-m4t-medium")
FSDP_ARCHS = ("qwen3-0.6b", "llama4-scout-17b-a16e")

LOSS_RTOL, GRAD_REL_L2 = 1e-4, 2e-2
LOGIT_RTOL, LOGIT_ATOL = 0.02, 0.08
SPLIT_LOSS_RTOL, SPLIT_GRAD_REL_L2 = 5e-3, 0.25

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, out, case = sys.argv[1:6]
rank, world = int(rank), int(world)
archs = sys.argv[6].split(",")
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
try:
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, moe
    from repro_torch.sharding import act
    from repro_torch.sharding import specs as sh
    from repro_torch.train.loop import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    if case == "fsdp":
        sh.FSDP_THRESHOLD_BYTES = 0
        moe.GROUPED_BANK_BYTES = 0
        moe.FORCE_IMPL = "dense"
    dims = (1, 1) if world == 1 else (2, world // 2)
    mesh = make_mesh("cpu", dims, ("data", "model"))
    B, S, DEC = 4, 8, 3

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def put(tree, shardings):
        return tree_map(lambda x, s: distribute_tensor(
            x, mesh, s.placements), tree, shardings)

    def rel(got, want):
        got, want = full(got).detach().double(), want.detach().double()
        assert got.shape == want.shape, (got.shape, want.shape)
        return float((got - want).norm() / want.norm().clamp(min=1e-30))

    def run(params, batch, toks, sharded):
        pre = {k: v for k, v in batch.items() if k != "labels"}
        lf = api.loss_fn(cfg, "block")
        dryrun._policy(mesh, "megatron")
        try:
            with implicit_replication():
                loss, grads = value_and_grad(lf, params, batch)
                with torch.no_grad():
                    logits, _ = api.prefill_fn(cfg)(params, pre)
                    st = api.init_decode_state(cfg, B, S + DEC, device="cpu")
                    if sharded:
                        st = put(st, sh.decode_state_shardings(st, mesh, cfg))
                    dec = []
                    for t in range(DEC):
                        tk = toks[:, t:t + 1]
                        if sharded:
                            pl = sh.batch_shardings({"t": tk}, mesh)["t"]
                            tk = distribute_tensor(tk, mesh, pl.placements)
                        lg, st = api.decode_fn(cfg)(params, st, tk)
                        dec.append(lg)
        finally:
            act.clear_policy()
        return loss, tree_leaves(grads), logits, dec

    res = {}
    for arch in archs:
        cfg = get_arch(arch, smoke=True)
        params = api.init_params(cfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + DEC)),
                               dtype=torch.int32)
        batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
        fr = cfg.input_specs(ShapeConfig("t", "train", S, B)).get("frontend")
        if fr is not None:
            batch["frontend"] = torch.as_tensor(
                rng.standard_normal(tuple(fr.shape)), dtype=torch.bfloat16)
        want = run(params, batch, toks, False)
        g = torch.Generator().manual_seed(7)

        def nudge(w):
            sgn = torch.randint(0, 2, w.shape, generator=g) * 2 - 1
            return (w.double() * (1 + sgn * 2.0 ** -8)).to(w.dtype)

        dparams = put(params, sh.params_shardings(params, mesh, cfg))
        dbatch = put(batch, sh.batch_shardings(batch, mesh))
        r = {}
        for tag, got in (("sharded", run(dparams, dbatch, toks, True)),
                         ("nudged", run(tree_map(nudge, params), batch, toks,
                                        False))):
            loss, grads, logits, dec = got
            r[tag] = {
                "finite": all(bool(torch.isfinite(full(t)).all())
                              for t in [loss, logits, *grads, *dec]),
                "loss_rel": abs(float(full(loss)) - float(want[0]))
                / abs(float(want[0])),
                "grad_rel_l2": max(rel(a, b) for a, b in zip(grads, want[1])),
                "prefill_rel_l2": rel(logits, want[2]),
                "decode_rel_l2": max(rel(a, b) for a, b in zip(dec, want[3])),
            }
            if tag == "sharded":
                r[tag]["logits_close"] = all(torch.allclose(
                    full(a).float(), b.float(), rtol=float(sys.argv[7]),
                    atol=float(sys.argv[8])) for a, b in zip(
                        [logits, *dec], [want[2], *want[3]]))
        res[arch] = r
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(tmp_path, world: int, case: str, archs) -> dict:
    """``_WORKER`` in ``world`` processes -> rank 0's results by arch."""
    out = tmp_path / f"{case}_{world}.json"
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), port, str(out),
         case, ",".join(archs), str(LOGIT_RTOL), str(LOGIT_ATOL)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("w1"), 1, "megatron", ARCHS)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("w4"), 4, "megatron", ARCHS)


@pytest.fixture(scope="module")
def four_fsdp(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("w4f"), 4, "fsdp", FSDP_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_equals_plain_on_a_1x1_mesh(one, arch):
    r = one[arch]["sharded"]
    assert r["finite"]
    assert r["loss_rel"] <= LOSS_RTOL, r
    assert r["grad_rel_l2"] <= GRAD_REL_L2, r
    assert r["logits_close"], r


def _within_rounding(r, arch):
    s, n = r["sharded"], r["nudged"]
    assert s["finite"] and n["finite"]
    assert s["loss_rel"] <= SPLIT_LOSS_RTOL, (arch, s)
    assert s["grad_rel_l2"] <= SPLIT_GRAD_REL_L2, (arch, s)
    for k in ("grad_rel_l2", "prefill_rel_l2", "decode_rel_l2"):
        assert s[k] <= n[k], (arch, k, s, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_within_rounding_on_a_2x2_mesh(four, arch):
    _within_rounding(four[arch], arch)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_and_expert_parallel_within_rounding_on_a_2x2_mesh(four_fsdp,
                                                                arch):
    _within_rounding(four_fsdp[arch], arch)
