"""The Jamba2 decode cell at the CPU tests' size: the configuration file,
inputs, reference, arithmetic, every new reader, and whole runs (sound,
and the control)."""
from __future__ import annotations

import json
import math
import time

import pytest
import torch

from portbench import control, harness, roofline_hybrid, run
from portbench.drivers import hybrid_decode, lm_decode
from portbench.inputs import jamba as jamba_inputs
from portbench.tests import _cells

WORKLOAD = "jamba2_decode_b64"
ref = harness.load_reference("jamba2_mini")
SMOKE = json.loads((_cells.DATA / "jamba2_mini_smoke.json").read_text())
TRAFFIC = {"slots": 4, "max_seq": 256, "max_new": 250, "warm_ticks": 1}
NEW = ("mamba_issue_ms.jamba", "mamba_state_ms.jamba",
       "moe_local_share.jamba", "jamba_mfu")
#: the LM cells' readers, which read the engine, the model step and the
#: dispatch that this cell runs too
LM = ("tick_ms_p95.lm", "kernels_per_tick.lm", "device_idle.lm",
      "tick_issue_ms.lm", "tick_fence_ms.lm", "attn_issue_ms.lm",
      "moe_issue_ms.lm", "experts_hit.lm", "moe_row_fill.lm",
      "prefill_ms.lm")

#: the catalog's ``config`` of AI21-Jamba2-Mini (the model-configs
#: guide's architectures.jsonl), which the file holds but for the keys it
#: lists under ``reduced``
CATALOG = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
    "mamba_dt_rank": 256, "mamba_expand": 2, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "model_type": "jamba",
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8,
    "num_logits_to_keep": 1, "rms_norm_eps": 1e-06, "sliding_window": None,
    "tie_word_embeddings": False, "use_mamba_kernels": True,
    "vocab_size": 65536}


def _small():
    wl = harness.workload(harness.manifest(), WORKLOAD)
    return wl, dict(harness.load_traffic(wl["traffic"]), **TRAFFIC)


def test_the_file_is_the_catalog_entry_but_the_experts_held():
    man = harness.manifest()
    cfg = harness.load_config(man, "jamba2_mini")
    entry = harness.config_entry(man, "jamba2_mini")
    assert entry["reduced"] == cfg["reduced"] == ["num_experts"]
    assert entry["source"] == cfg["source"]
    for k, v in CATALOG.items():
        if k not in cfg["reduced"]:
            assert cfg[k] == v, k
    assert cfg["published_num_experts"] == CATALOG["num_experts"]
    lo, hi = cfg["experts_held"]
    assert (lo, hi - lo) == (0, cfg["num_experts"]) == (0, 8)
    assert cfg["assumed"]["capacity_factor"] == 1.25
    traffic = harness.load_traffic(harness.workload(man, WORKLOAD)[
        "traffic"])
    # each held expert sees what it would in the deployment: 8 rows a tick
    assert traffic["slots"] * 2 / 16 == 8
    assert traffic["prompt_len"] + traffic["max_new"] == traffic["max_seq"]


def test_weights_repeat_for_a_seed_and_the_router_reads_only_the_code():
    a = jamba_inputs.make_weights(SMOKE, 2 ** 31 + 7, "cpu")
    b = jamba_inputs.make_weights(SMOKE, 2 ** 31 + 7, "cpu")
    c = jamba_inputs.make_weights(SMOKE, 2 ** 31 + 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mamba.w_in"], c["mamba.w_in"])
    d, e = SMOKE["hidden_size"], SMOKE["published_num_experts"]
    assert not a["moe.router"][:, :d - e].any()
    for name in jamba_inputs.WRITERS:
        assert not a[name][..., d - e:].any()
    code = a["embed"][:, d - e:].float() / jamba_inputs.CODE_UNIT
    assert ((code > 0).sum(1) == 2).all()
    r = a["moe.router"][:, d - e:]
    assert ((r > 0).sum(1) == 1).all() and ((r > 0).sum(2) == 1).all()
    assert torch.allclose(a["mamba.a_log"][0, 0].exp(),
                          torch.arange(1.0, SMOKE["mamba_d_state"] + 1))
    dt = torch.nn.functional.softplus(a["mamba.dt_b"])
    assert (dt >= 0.99e-3).all() and (dt <= 1.01e-1).all()


def test_the_benchmark_tree_is_the_program_layout():
    from repro_torch.models import api

    raw = jamba_inputs.make_weights(SMOKE, 1, "cpu")
    arch = hybrid_decode.arch_config(SMOKE)
    params = hybrid_decode.port_params(raw, SMOKE)
    lm_decode.same_layout(params, api.init_params(arch, device="meta"))
    # layer 8 r + 5 is the 7 r + 5th Mamba layer, the 4 r + 3rd MoE layer
    full = harness.load_config(harness.manifest(), "jamba2_mini")
    meta = {k: torch.empty(s, device="meta") for k, (s, _, _) in
            jamba_inputs.shapes(full).items()}
    blocks = hybrid_decode.port_params(meta, full)["blocks"]
    for r in range(4):
        for got, want in ((blocks[5]["mamba"]["w_in"][r],
                           meta["mamba.w_in"][7 * r + 4]),
                          (blocks[5]["moe"]["router"][r],
                           meta["moe.router"][4 * r + 2]),
                          (blocks[4]["attn"]["wq"][r], meta["attn.wq"][r])):
            assert got.shape == want.shape
    assert [b.stride(0) for b in (blocks[5]["mamba"]["a_log"],
                                  blocks[5]["moe"]["router"],
                                  blocks[0]["mlp"]["wo"])] == [
        7 * meta["mamba.a_log"].stride(0), 4 * meta["moe.router"].stride(0),
        4 * meta["dense.w_down"].stride(0)]
    assert params["blocks"][5]["mamba"]["w_in"][0].data_ptr() == \
        raw["mamba.w_in"][4].data_ptr()
    assert params["blocks"][5]["moe"]["router"][0].data_ptr() == \
        raw["moe.router"][2].data_ptr()
    with pytest.raises(ValueError):
        hybrid_decode.arch_config(dict(SMOKE, mamba_d_conv=3))
    with pytest.raises(ValueError):
        hybrid_decode.arch_config(dict(SMOKE, num_experts=4))
    with pytest.raises(ValueError):  # the port's dt rank is d_model // 16
        hybrid_decode.arch_config(dict(SMOKE, mamba_dt_rank=8))


def test_tick_flops_against_the_active_parameters():
    from repro_torch.models import api

    for cfg in (SMOKE, harness.load_config(harness.manifest(),
                                           "jamba2_mini")):
        arch = hybrid_decode.arch_config(cfg)
        d, v = cfg["hidden_size"], cfg["vocab_size"]
        di, n = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
        nm = jamba_inputs.counts(cfg)["mamba"]
        norms = d * (2 * cfg["num_hidden_layers"] + 1)
        # a Mamba layer's leaves that are no product's weights: the conv
        # and dt biases, D, the inner norms; A_log's Di x N counted as the
        # scan's two multiply-adds a state element
        vectors = nm * (3 * di + cfg["mamba_dt_rank"] + 2 * n)
        matmul = api.active_param_count(arch) - v * d - norms - vectors
        k = cfg["num_experts_per_tok"]
        per_token = roofline_hybrid.tick_flops(cfg, 1, 0, k)
        assert per_token == 2 * (matmul + nm * di * n)
        att = 2 * 2 * d * jamba_inputs.counts(cfg)["attn"] * 100
        assert roofline_hybrid.tick_flops(cfg, 1, 100, k) == per_token + att


def test_a_sound_run_is_correct():
    wl, traffic = _small()
    out, checks, _ = run.execute(wl, 1234567890123, 0.3, False,
                                 device="cpu", config=SMOKE,
                                 traffic=traffic, t0=time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert checks["max_gap"]["value"] <= checks["max_gap"]["limit"]


def test_the_control_is_not_correct():
    """At a fixed count of ticks: the served tokens, and so the gaps, do
    not depend on the host's speed.  (At this size and seed the program
    reads 0.015, the control 1.99.)"""
    wl, traffic = _small()
    cell = hybrid_decode.Cell(SMOKE, traffic, 1, "cpu",
                              harness.load_limits(wl["name"]))
    cell.setup()
    for _ in range(40):
        cell._tick()
    cell.release()
    assert harness.checks_pass(cell.check(ref))
    assert not harness.checks_pass(cell.check(ref, control=True))


def test_every_new_reader_reads_the_small_cell():
    wl, traffic = _small()
    man = harness.manifest()
    per = {m["name"]: m for m in harness.cell_metrics(man, WORKLOAD,
                                                      "per_layer")}
    assert set(per) == set(NEW + LM)
    for name in NEW + LM:
        assert harness.load_metric(name).read({}) is None
        assert harness.load_metric(name).read(
            {"window": {}, "trace": None}) is None
    cell = hybrid_decode.Cell(SMOKE, traffic, 2 ** 40 + 19, "cpu",
                              harness.load_limits(wl["name"]))
    cell.setup()
    cell.window(0.3)
    try:
        ctx = cell.context()
        # the device's share needs a profiled window, which only a card
        # gives: a stand-in summary here
        ctx["trace"] = {"busy_s": 0.25, "window_s": 1.0,
                        "kernel_count": 300, "steps": 3}
        got = harness.read_metrics([per[n] for n in NEW + LM], ctx)
    finally:
        cell.release()
    assert set(got) == set(NEW + LM)
    assert all(math.isfinite(v["value"]) and v["value"] > 0
               for v in got.values())
    assert got["device_idle.lm"]["value"] == 75.0
    assert got["kernels_per_tick.lm"]["value"] == 100.0
    assert 0 < got["moe_local_share.jamba"]["value"] < 100
    # experts hit and rows filled count the 8 held experts only
    assert got["experts_hit.lm"]["value"] <= 8
    assert got["moe_row_fill.lm"]["value"] <= 100


def test_the_cell_reports_what_the_manifest_asks():
    man = harness.manifest()
    e2e = {m["name"] for m in harness.cell_metrics(man, WORKLOAD,
                                                   "end_to_end")}
    assert e2e == {"tokens_per_s", "setup_s"}
    moves = {m["name"]: m["moves"] for m in harness.cell_metrics(
        man, WORKLOAD, "per_layer")}
    assert moves == {n: "setup_s" if n == "prefill_ms.lm" else
                     "tokens_per_s" for n in NEW + LM}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_program_passes_and_control_fails_at_cell_size(card):
    rec = control.readings(WORKLOAD, 20261018, 3.0, True)
    assert harness.checks_pass(rec["program"])
    assert not harness.checks_pass(rec["control"])
