"""The MoE decode cell at the CPU tests' size: inputs, reference,
arithmetic, and whole runs (sound, the control, and the timed path broken
underneath)."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness, roofline
from portbench.drivers import lm_decode
from portbench.inputs import lm as lm_inputs
from portbench.tests import _cells

ref = harness.load_reference("deepseek_moe_16b")
SMOKE = json.loads((_cells.DATA / "deepseek_moe_16b_smoke.json").read_text())


def test_weights_and_prompts_repeat_for_a_seed_and_differ_across():
    a = lm_inputs.make_weights(SMOKE, 2 ** 31 + 7, "cpu")
    b = lm_inputs.make_weights(SMOKE, 2 ** 31 + 7, "cpu")
    c = lm_inputs.make_weights(SMOKE, 2 ** 31 + 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["moe.e_gate"], c["moe.e_gate"])
    p = lm_inputs.prompts(SMOKE, 5, 4, 4)
    assert (p == lm_inputs.prompts(SMOKE, 5, 4, 4)).all()
    assert (p != lm_inputs.prompts(SMOKE, 6, 4, 4)).any()


def test_the_router_reads_only_the_code_and_no_layer_writes_it():
    raw = lm_inputs.make_weights(SMOKE, 3, "cpu")
    d, e = SMOKE["hidden_size"], SMOKE["n_routed_experts"]
    k = SMOKE["num_experts_per_tok"]
    assert not raw["moe.router"][:, :d - e].any()
    for name in lm_inputs.WRITERS:
        assert not raw[name][..., d - e:].any()
    code = raw["embed"][:, d - e:].float() / lm_inputs.CODE_UNIT
    assert ((code > 0).sum(1) == k).all()
    assert sorted(code[0][code[0] > 0].tolist()) == list(range(1, k + 1))
    # each layer's router is a permutation of the experts
    r = raw["moe.router"][:, d - e:]
    assert ((r > 0).sum(1) == 1).all() and ((r > 0).sum(2) == 1).all()


def test_keep_on_a_hand_checked_batch():
    # one decode position, rows (0, 1), (0, 1), (1, 0), cap int(3*2/2*.5)=1
    idx = torch.tensor([[[0, 1]], [[0, 1]], [[1, 0]]])
    idx = torch.cat([torch.zeros_like(idx), idx], 1)     # a prefill token
    keep = ref._keep(idx, 1, 2, 0.5)
    assert keep[:, 0].all()
    assert keep[:, 1].tolist() == [[True, False], [False, False],
                                   [True, False]]


def test_keep_equals_the_program_dispatch_positions():
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(0)
    b, k, e = 32, 6, 64
    idx = torch.stack([torch.randperm(e, generator=g)[:k]
                       for _ in range(b)])
    cap = max(1, int(b * k / e * 1.25))
    _, keep_list = moe._positions(idx, e, cap)
    want = torch.stack(keep_list, -1)
    got = ref._keep(idx[:, None], 0, e, 1.25)[:, 0]
    assert torch.equal(got, want) and not want.all()


def test_rope_against_the_program():
    from repro_torch.models.layers import apply_rope

    x = torch.randn(2, 5, 3, 8, generator=torch.Generator().manual_seed(1))
    want = apply_rope(x, torch.arange(5)[None], 1e4)
    assert torch.allclose(ref._rope(x, 1e4), want, atol=1e-6)
    assert torch.equal(ref._rope(x, 1e4)[:, 0], x[:, 0])


def test_token_flops_against_the_active_parameters():
    from repro_torch.models import api

    man = harness.manifest()
    for cfg in (SMOKE, harness.load_config(man, "deepseek_moe_16b")):
        arch = lm_decode.arch_config(cfg)
        d, v = cfg["hidden_size"], cfg["vocab_size"]
        norms = d * (2 * cfg["num_hidden_layers"] + 1)
        matmul = api.active_param_count(arch) - v * d - norms
        assert roofline.lm_token_flops(cfg, 0) == 2 * matmul
        att = 2 * 2 * d * cfg["num_hidden_layers"] * 100
        assert roofline.lm_token_flops(cfg, 100) == 2 * matmul + att


def test_the_benchmark_tree_is_the_program_layout():
    from repro_torch.models import api

    raw = lm_inputs.make_weights(SMOKE, 1, "cpu")
    arch = lm_decode.arch_config(SMOKE)
    params = lm_decode.port_params(raw, SMOKE["first_k_dense_replace"])
    lm_decode.same_layout(params, api.init_params(arch, device="meta"))
    with pytest.raises(ValueError):
        lm_decode.same_layout(dict(params, lm_head=raw["embed"]),
                              api.init_params(arch, device="meta"))


def test_a_sound_run_is_correct_and_prints_every_metric():
    out, checks = _cells.run_small("moe_decode_b32")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert checks["max_gap"]["value"] <= checks["max_gap"]["limit"]


def test_the_control_is_not_correct():
    """At a fixed count of ticks: the served tokens, and so the gaps, do
    not depend on the host's speed."""
    wl, config, traffic = _cells.small("moe_decode_b32")
    cell = lm_decode.Cell(config, traffic, 7, "cpu",
                          harness.load_limits(wl["name"]))
    cell.setup()
    for _ in range(40):
        cell._tick()
    cell.release()
    assert harness.checks_pass(cell.check(ref))
    assert not harness.checks_pass(cell.check(ref, control=True))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for v in x for t in _leaves(v)]


def _unchanged(orig):
    def step(cfg, params, state, tokens):
        kept = [(t, t.clone()) for t in _leaves(state["layers"])
                + _leaves(state["head"])]
        logits, new = orig(cfg, params, state, tokens)
        for t, old in kept:
            t.copy_(old)
        return logits, new
    return step


def _half(orig):
    def step(cfg, params, state, tokens):
        logits, new = orig(cfg, params, state, tokens)
        b = logits.shape[0]
        if b > 1:
            logits = logits.clone()
            logits[b // 2:] = logits[:b - b // 2]
        return logits, new
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "token_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    from repro_torch.models import stack
    from repro_torch.serve import sampler

    if fault == "token_altered":
        orig = sampler.greedy
        monkeypatch.setattr(sampler, "greedy",
                            lambda lg, vocab: (orig(lg, vocab) + 1) % vocab)
    else:
        wrap = _unchanged if fault == "state_unchanged" else _half
        monkeypatch.setattr(stack, "decode_step", wrap(stack.decode_step))
    out, checks = _cells.run_small("moe_decode_b32")
    assert not out["correct"]
    assert checks["max_gap"]["value"] > checks["max_gap"]["limit"]
