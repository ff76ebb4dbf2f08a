"""The manifest, discovery by name, the result line and the import guard."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_manifest_contract(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert set(c["reduced"]) <= set(harness.load_config(man, c["name"]))
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        got = {m["name"] for m in harness.cell_metrics(man, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(man, w["name"], "per_layer")
    assert len(json.dumps(man)) < 64 * 1024


def test_every_name_finds_its_files(man):
    for w in man["workloads"]:
        traffic = harness.load_traffic(w["traffic"])
        assert harness.load_driver(traffic["driver"]).Cell
        assert harness.load_limits(w["name"])
        assert harness.load_reference(w["config"])
        assert harness.load_config(man, w["config"])["name"] == w["config"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_a_cell_from_new_files_only(tmp_path, man):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new manifest entries: no existing file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench")
    bench = root / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "pscnn_kws.json").read_text())
    cfg["name"] = "pscnn_kws_w32"
    (bench / "configs" / "pscnn_kws_w32.json").write_text(json.dumps(cfg))
    traffic = harness.load_traffic("closed_rounds_hop8")
    (bench / "traffic" / "open_half.json").write_text(
        json.dumps(dict(traffic, streams=1024)))
    (bench / "checks" / "kws_w32_half.json").write_text(
        json.dumps({"logit_mismatch": 0, "post_err": 1e-5}))
    shutil.copy(bench / "reference" / "pscnn_kws.py",
                bench / "reference" / "pscnn_kws_w32.py")
    (bench / "metrics" / "rounds.kws.py").write_text(
        "def read(ctx):\n    return ctx['window'].get('rounds')\n")
    new = json.loads(json.dumps(man))
    new["configs"].append({"name": "pscnn_kws_w32", "source": "x",
                           "file": "portbench/configs/pscnn_kws_w32.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "kws_w32_half",
                             "config": "pscnn_kws_w32",
                             "traffic": "open_half", "chips": 1, "why": "x"})
    for m in new["end_to_end"]:
        if m["name"] in ("audio_s_per_s", "hop_p95_ms"):
            m["workloads"].append("kws_w32_half")
    new["per_layer"].append({"name": "rounds.kws", "unit": "rounds",
                             "better": "higher", "source": "host_clock",
                             "layer": "ingest (stream/state.py RingArena)",
                             "moves": "audio_s_per_s",
                             "workloads": ["kws_w32_half"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    for p, data in before.items():
        assert p.read_bytes() == data
    found = harness.manifest(root)
    wl = harness.workload(found, "kws_w32_half")
    assert harness.load_config(found, wl["config"], root)["name"] == \
        "pscnn_kws_w32"
    assert harness.load_traffic(wl["traffic"], bench)["streams"] == 1024
    assert harness.load_limits(wl["name"], bench)["logit_mismatch"] == 0
    assert harness.load_reference(wl["config"], bench).forward
    per = harness.cell_metrics(found, wl["name"], "per_layer")
    assert [m["name"] for m in per] == ["rounds.kws"]
    ctx = {"window": {"rounds": 7, "audio_s": 3.0, "wall_s": 1.5,
                      "hop_latency_s": [0.01, 0.02]}, "setup_s": 2.0}
    assert harness.read_metrics(per, ctx, bench) == {
        "rounds.kws": {"value": 7.0, "unit": "rounds"}}
    e2e = harness.read_metrics(
        harness.cell_metrics(found, wl["name"], "end_to_end"), ctx, bench)
    assert set(e2e) == {"audio_s_per_s", "hop_p95_ms", "setup_s"}


def test_reader_that_finds_nothing_is_left_out(man):
    per = harness.cell_metrics(man, "kws_saturated", "per_layer")
    got = harness.read_metrics(per, {"window": {}, "trace": None})
    assert got == {}


def test_result_line_keys():
    checks = {"logit_mismatch": {"value": 0, "limit": 0}}
    line = harness.result_line(
        correct=True, attempted=8, failed=0,
        metrics={"setup_s": {"value": 1.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "x", "count": 1,
                "memory_peak_bytes": 5},
        checks=checks, breakdown={"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert harness.check_lines(checks) == [
        "check logit_mismatch: 0 (limit 0)"]
    assert not harness.checks_pass({"a": {"value": 1e-4, "limit": 1e-5}})


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.stream", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax", "benchmarks_torch.common", "chip_smoke",
         "flax.linen"]) == ["benchmarks_torch.common", "chip_smoke",
                            "flax.linen", "jax", "repro.core"]


def test_nothing_imports_jax_or_the_jax_package():
    """Every module of the benchmark, loaded in a fresh process, brings
    in no JAX and nothing of the JAX package; the references bring in
    nothing of the port either."""
    code = """
import sys
sys.path[:0] = ['.', 'src']
from portbench import harness, run, trace, roofline, control
from portbench.drivers import kws_stream, lm_decode
import repro_torch.stream, repro_torch.serve.engine, repro_torch.models.api
import repro_torch.kernels.dispatch
man = harness.manifest()
for m in man['end_to_end'] + man['per_layer']:
    harness.load_metric(m['name'])
for w in man['workloads']:
    harness.load_reference(w['config'])
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    refs = """
import sys
sys.path[:0] = ['.']
import importlib.util
for name in ('pscnn_kws', 'deepseek_moe_16b'):
    spec = importlib.util.spec_from_file_location(
        name, f'portbench/reference/{name}.py')
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted({n.split('.')[0] for n in sys.modules}
             & {'repro_torch', 'repro', 'jax', 'portbench'}))
"""
    out = subprocess.run([sys.executable, "-c", refs], capture_output=True,
                         text=True, cwd=harness.ROOT, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_without_a_card(monkeypatch, capsys):
    torch = pytest.importorskip("torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(harness, "setup_env", lambda: None)
    assert run.main(["--workload", "kws_saturated", "--seed", "5",
                     "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA card" in out.err


def test_config_files_are_what_the_port_runs():
    from repro_torch.configs.deepseek_moe_16b import CONFIG
    from repro_torch.models.kws import build_kws_spec

    from portbench.drivers import kws_stream, lm_decode

    man = harness.manifest()
    spec = kws_stream.port_spec(harness.load_config(man, "pscnn_kws"))
    want = build_kws_spec()
    assert spec.layers == want.layers and spec.in_len == want.in_len
    arch = lm_decode.arch_config(harness.load_config(man,
                                                     "deepseek_moe_16b"))
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "rope_theta", "moe",
                  "qk_norm", "tie_embeddings", "quant_mode"):
        assert getattr(arch, field) == getattr(CONFIG, field), field
