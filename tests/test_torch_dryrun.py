"""The port's launch tools (``repro_torch.launch.roofline``, ``dryrun``,
``hillclimb``, ``report``) and ``benchmarks_torch`` against the
reference's, and the dry run itself on a fake 2x2 world at smoke size.

``repro.launch.dryrun`` and ``hillclimb`` set ``XLA_FLAGS`` to 512 host
devices when imported, so the reference's side of their functions runs in
one subprocess.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.launch import report as ref_report
from repro.launch import roofline as ref_rl
from repro_torch.configs.base import SHAPES, ShapeConfig, arch_names, get_arch
from repro_torch.launch import dryrun, hillclimb, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import layers
from repro_torch.sharding import act

ROOT = pathlib.Path(__file__).resolve().parent.parent


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMeshMP:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

def test_collective_bytes_match_reference():
    for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                 "collective-permute"):
        for ob, rb in ((1024, 16384), (16384, 1024), (4096, 4096)):
            assert rl.Collective(kind, ob, rb).moved_bytes == \
                ref_rl.Collective(kind, ob, rb).moved_bytes


def test_collectives_from_ops_maps_the_functional_ops():
    ops = [("all_gather_into_tensor", 64, 1024), ("all_reduce", 256, 256),
           ("reduce_scatter_tensor", 1024, 64), ("all_to_all_single", 32,
                                                 32)]
    colls = rl.collectives_from_ops(ops)
    assert [c.kind for c in colls] == ["all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all"]
    agg, total = rl.aggregate(colls)
    assert agg["all-gather"] == (1, 960) and agg["all-reduce"] == (1, 512)
    assert total == 960 + 512 + 960 + 32


def test_roofline_terms_with_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 50e9)
    r = rl.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=50e9 / 2,
                    collectives={"all-reduce": (3, 1.0)})
    ref = ref_rl.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0,
                          collectives={})
    s = r.summary()
    assert set(s) == set(ref.summary())
    assert (s["compute_s"], s["memory_s"], s["collective_s"]) == (1.0, 2.0,
                                                                  0.5)
    assert s["dominant"] == "memory" and s["step_s_lower_bound"] == 2.0


def test_model_flops_match_reference():
    assert rl.model_flops_train(7, 11) == ref_rl.model_flops_train(7, 11)
    assert rl.model_flops_infer(7, 11) == ref_rl.model_flops_infer(7, 11)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _cells():
    roof = rl.Roofline(flops=1e12, hbm_bytes=2e11, coll_bytes=3e9,
                       collectives={"all-reduce": (2, 3e9)}).summary()
    ok = {"arch": "a", "shape": "train_4k", "mesh": "16x16", "status": "ok",
          "roofline": roof, "mem": {"peak_gb": 12.345},
          "useful_flops_frac": 0.5}
    return [
        ok, dict(ok, useful_flops_frac=0.0, arch="z"),
        dict(ok, useful_flops_frac=None, arch="n"),
        dict(ok, cost_note="memory proof only (--no-cost)", arch="c"),
        {"arch": "b", "shape": "long_500k", "mesh": "2x16x16",
         "status": "skip"},
        {"arch": "f", "shape": "decode_32k", "mesh": "16x16",
         "status": "fail", "error": "RuntimeError: " + "x" * 100},
    ]


def test_report_lines_match_reference():
    cells = _cells()
    assert report.roofline_lines(cells) == ref_report.roofline_lines(cells)
    bench = json.loads((ROOT / "BENCH_stream.json").read_text())
    assert report.stream_lines(bench) == ref_report.stream_lines(bench)
    small = {"sweep": {"8": {"hop_ms_p50": 1.0, "hop_ms_p99": float("nan")}},
             "sharded": None, "multi_tenant": {}}
    assert report.stream_lines(small) == ref_report.stream_lines(small)


# ---------------------------------------------------------------------------
# cell planning against the reference (one subprocess)
# ---------------------------------------------------------------------------

_REF_SCRIPT = r"""
import json
from repro.configs.base import SHAPES, arch_names, get_arch
from repro.launch import dryrun, hillclimb

class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}

class FakeMeshMP:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}

out = {"micro": {}, "opt": {}, "reduced": {}, "repeats": {}}
for a in arch_names():
    cfg = get_arch(a)
    out["opt"][a] = dryrun.pick_optimizer(cfg)
    out["repeats"][a] = dryrun._full_repeats(cfg)
    for n in (1, 2):
        r = dryrun._reduced_cfg(cfg, n)
        out["reduced"][f"{a}/{n}"] = [r.n_layers, r.n_enc_layers]
    for s in SHAPES:
        for mname, m in (("16x16", FakeMesh()), ("2x16x16", FakeMeshMP())):
            for prof in ("megatron", "dp_only"):
                out["micro"][f"{a}/{s}/{mname}/{prof}"] = \
                    dryrun.pick_microbatches(cfg, SHAPES[s], m, prof)
out["variants"] = [hillclimb.parse_variant(v) for v in (
    "dp_only:profile=dp_only", "dots:remat=dots,kv_replication=2",
    "base", "x:compression=int8")]
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _ref_proc():
    """The reference's subprocess, started with the first test of this
    module that runs (never at collection), so that it overlaps the
    tests before ``ref_plan``; killed at the module's end if still up."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref_plan(_ref_proc):
    out, err = _ref_proc.communicate(timeout=300)
    assert _ref_proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the counter and the dry run on a fake 2x2 world
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh2x2():
    with fake_world(4):
        yield make_mesh("cpu", (2, 2), ("data", "model"))
    act.clear_policy()


def test_local_flops_of_sharded_and_replicated_matmuls(mesh2x2):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    counter = rl.CostCounter()
    m, k, n = 64, 32, 48
    with counter:
        x = DTensor.from_local(torch.empty(m, k), mesh2x2,
                               [Replicate(), Replicate()], run_check=False)
        w_col = DTensor.from_local(torch.empty(k, n // 2), mesh2x2,
                                   [Replicate(), Shard(1)], run_check=False)
        w_rep = DTensor.from_local(torch.empty(k, n), mesh2x2,
                                   [Replicate(), Replicate()],
                                   run_check=False)
        with counter.track((x, w_col)):
            y = x @ w_col
        sharded = counter.flops
        assert tuple(y.to_local().shape) == (m, n // 2)
        with counter.track((x, w_rep)):
            x @ w_rep
        replicated = counter.flops
    assert replicated == 2 * m * k * n
    assert sharded * 2 == replicated


def test_megatron_mlp_issues_one_all_reduce(mesh2x2):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    counter = rl.CostCounter()
    b, s, d, f = 4, 8, 16, 32
    act.set_policy(mesh2x2, "data", "model")
    with counter:
        x = DTensor.from_local(torch.empty(b // 2, s, d,
                                           dtype=torch.bfloat16), mesh2x2,
                               [Shard(0), Replicate()], run_check=False)
        p = {k: DTensor.from_local(torch.empty(*shp, dtype=torch.bfloat16),
                                   mesh2x2, [Replicate(), Shard(sd)],
                                   run_check=False)
             for k, shp, sd in (("wi_gate", (d, f // 2), 1),
                                ("wi_up", (d, f // 2), 1),
                                ("wo", (f // 2, d), 0))}
        with counter.track((x, p)):
            out = act.constrain(layers.apply_mlp(p, x), "dp", None, None)
        assert tuple(out.placements) == (Shard(0), Replicate())
    kinds = [name for name, _, _ in counter.collective_ops]
    assert kinds == ["all_reduce"]
    # the local products: 3 matmuls of (b/2 * s) x d x f/2
    assert counter.flops == 3 * 2 * (b // 2 * s) * d * (f // 2)


@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "train"),
                                       ("deepseek-moe-16b", "decode")])
def test_extrapolated_costs_equal_a_full_depth_count(arch, kind, mesh2x2):
    cfg = get_arch(arch, smoke=True)
    shape = ShapeConfig("t", kind, 32, 4)
    dryrun._policy(mesh2x2, "megatron")
    with dryrun._slstm_standin_on():
        m = [dryrun.measure(dryrun._LOWER[kind], dryrun._reduced_cfg(cfg, n),
                            shape, mesh2x2, "cpu") for n in (1, 2, 3)]
    ex = dryrun.extrapolate(m[0], m[1], 3)
    for k in ("flops", "bytes", "coll", "colls", "args"):
        assert ex[k] == m[2][k] and m[2][k], k
    # the peak is linear in depth within a few percent
    assert abs(ex["peak"] / m[2]["peak"] - 1) < 0.05


def test_run_cell_records_its_torch_and_plan():
    cfg = get_arch("qwen3-0.6b", smoke=True)
    kw = dict(device="cpu", mesh_name="2x2", cfg=cfg,
              shape=ShapeConfig("train", "train", 32, 4), plan=True)
    ex = dryrun.run_cell("qwen3-0.6b", "train", False, **kw)
    full = dryrun.run_cell("qwen3-0.6b", "train", False, full_depth=True,
                           **kw)
    for c in (ex, full):
        assert c["status"] == "ok", c.get("error")
        assert c["torch"] == torch.__version__
        assert c["counter_hook"] in ("_fake_mode_lock",
                                     "_propagate_tensor_meta_non_cached")
    assert sorted(ex["plan"]) == [1, 2] and list(full["plan"]) == [2]
    kinds = {k for k, _, _ in full["plan"][2]["collectives"]}
    assert kinds <= {"all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "all_to_all_single"}
    # the extrapolation from 1 and 2 superblocks is the full count (the
    # smoke config has 2)
    assert ex["roofline"] == full["roofline"]
    assert ex["mem"]["peak_gb"] == full["mem"]["peak_gb"]


@pytest.mark.parametrize("arch,kind", [
    ("qwen3-0.6b", "train"), ("qwen3-0.6b", "prefill"),
    ("qwen3-0.6b", "decode"), ("xlstm-350m", "prefill"),
    ("seamless-m4t-medium", "decode")])
def test_run_cell_at_smoke_size(arch, kind):
    cfg = get_arch(arch, smoke=True)
    cell = dryrun.run_cell(arch, kind, False, device="cpu",
                           mesh_name="2x2", cfg=cfg,
                           shape=ShapeConfig(kind, kind, 32, 4))
    assert cell["status"] == "ok", cell.get("error")
    assert cell["mem"]["peak_gb"] >= cell["mem"]["args_gb"] > 0
    assert cell["roofline"]["flops_per_dev"] > 0
    assert 0 < cell["useful_flops_frac"]
    n_s = cfg.superblock.count("s") * dryrun._full_repeats(cfg) \
        if cfg.superblock else 0
    assert cell.get("slstm_analytic", 0) == n_s


def test_main_writes_cells_and_exits_nonzero_on_failure(tmp_path,
                                                        monkeypatch):
    out = tmp_path / "cells"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                     "--multi-pod", "single", "--device", "cpu", "--out",
                     str(out)])
    assert e.value.code == 0
    cell = json.loads((out / "qwen3-0.6b__long_500k__16x16.json")
                      .read_text())
    assert cell["status"] == "skip"
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: {
        "status": "fail", "error": "x"})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-9b", "--shape", "train_4k",
                     "--multi-pod", "single", "--device", "cpu", "--out",
                     str(out)])
    assert e.value.code == 1


def test_dry_run_fakes_cuda_only_with_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        dryrun.run_cell("qwen3-0.6b", "train_4k", False)


# ---------------------------------------------------------------------------
# benchmarks_torch
# ---------------------------------------------------------------------------

def test_bench_suites_and_roofline_table(tmp_path):
    from benchmarks_torch import roofline_table, run

    assert set(run.SUITES) == {"kernel", "roofline"}
    for c in _cells():
        (tmp_path / f"{c['arch']}.json").write_text(json.dumps(c))
    rows = roofline_table.run(tmp_path)
    assert rows[0] == "roofline.cells,4ok/1fail/1skip,of 6 attempted"
    assert any(r.startswith("roofline.f/decode_32k/16x16,FAIL") for r in rows)
    assert roofline_table.run(tmp_path / "none")[0].startswith(
        "roofline.status,no results yet")


def test_kernel_bench_on_the_cpu(monkeypatch):
    from benchmarks_torch import common, kernel_bench

    monkeypatch.setattr(kernel_bench, "SHAPES", ((1, 64, 32, "decode-ish"),
                                                 (8, 64, 32, "batch-ish")))
    rows = kernel_bench.run(repeats=1, device="cpu")
    assert len(rows) == 6
    assert rows[0].startswith("kernel.decode-ish.pick,")
    timed_rows = [r for r in rows if ".us_" in r]
    assert len(timed_rows) == 4
    assert all(r.startswith(("kernel.decode-ish.cpu.us_",
                             "kernel.batch-ish.cpu.us_")) for r in timed_rows)
    assert all("bit-equal" in r and "host clock" in r for r in timed_rows)
    # the card is the default: without one the bench refuses to run,
    # and a CPU output is never timed as a device time
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        kernel_bench.run(repeats=1)
    with pytest.raises(RuntimeError, match="not on the card"):
        common.timed(torch.zeros, 4, repeats=1)
    assert common.timed(torch.zeros, 4, repeats=1, host_clock=True)[0] \
        .shape == (4,)


# ---------------------------------------------------------------------------
# last, so that the reference's subprocess overlaps the tests above
# ---------------------------------------------------------------------------

def test_cell_planning_matches_reference(ref_plan):
    for a in arch_names():
        cfg = get_arch(a)
        assert dryrun.pick_optimizer(cfg) == ref_plan["opt"][a], a
        assert dryrun._full_repeats(cfg) == ref_plan["repeats"][a], a
        for n in (1, 2):
            r = dryrun._reduced_cfg(cfg, n)
            assert [r.n_layers, r.n_enc_layers] == \
                ref_plan["reduced"][f"{a}/{n}"]
        for s in SHAPES:
            for mname, m in (("16x16", FakeMesh()),
                             ("2x16x16", FakeMeshMP())):
                for prof in ("megatron", "dp_only"):
                    key = f"{a}/{s}/{mname}/{prof}"
                    assert dryrun.pick_microbatches(
                        cfg, SHAPES[s], m, prof) == ref_plan["micro"][key], key


def test_parse_variant_matches_reference(ref_plan):
    got = [list(hillclimb.parse_variant(v)) for v in (
        "dp_only:profile=dp_only", "dots:remat=dots,kv_replication=2",
        "base", "x:compression=int8")]
    assert got == ref_plan["variants"]
