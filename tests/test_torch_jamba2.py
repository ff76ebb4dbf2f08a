"""AI21-Jamba2-Mini on the port (``repro_torch.configs.jamba2_mini``):
the published layer order, the published Jamba mixer and an MoE layer
that holds a share of its experts, against the benchmark's plain float32
reference (``portbench/reference/jamba2_mini.py``, which imports nothing
of the port) on the CPU at ``SMOKE`` size, with seeded random weights
from ``portbench/inputs/jamba.py`` handed to the port as views.

Tolerances, port (bf16 products and activations, float32 states) against
the float32 reference: logits within ``LOGIT_MAX`` at every position and
``LOGIT_MEAN`` on average.  Over seeds 1-3 the port's widest logit error
reads 0.10-0.23 and its mean 0.017-0.018 (bf16 roundings of every
activation through 8 layers); the reference with fp8 weights reads
1.43-1.72 and 0.155-0.181, so a port computing a precision below bf16
fails both.  A share of the experts against the whole layer, both in the
port's float32 combine: within ``SHARE_ATOL`` (the expert products run
as batches of 8 or 16 experts).
"""
from __future__ import annotations

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import harness
from portbench.drivers import hybrid_decode
from portbench.inputs import jamba as jamba_inputs
from portbench.inputs import lm as lm_inputs
from repro_torch.configs import base
from repro_torch.configs.jamba2_mini import CONFIG, SMOKE
from repro_torch.models import api, moe, ssm, stack
from repro_torch.serve import sampler
from repro_torch.serve.engine import Engine, Request

ref = harness.load_reference("jamba2_mini")
FILE = harness.load_config(harness.manifest(), "jamba2_mini")
SMOKE_FILE = json.loads((harness.BENCH / "tests" / "data"
                         / "jamba2_mini_smoke.json").read_text())

LOGIT_MAX, LOGIT_MEAN = 0.5, 0.05
SHARE_ATOL = 1e-5


@pytest.fixture(scope="module", params=[1, 2])
def model(request):
    raw = jamba_inputs.make_weights(SMOKE_FILE, request.param, "cpu")
    return raw, hybrid_decode.port_params(raw, SMOKE_FILE)


def _ref_logits(raw, tokens, prompt_len, cfg=SMOKE_FILE):
    h = ref.hidden(raw, cfg, tokens, prompt_len, 1.25)
    return h @ raw["lm_head"].to(torch.float32)


def _close(got, want, what):
    err = (got.to(torch.float32) - want).abs()
    assert float(err.max()) <= LOGIT_MAX, (what, float(err.max()))
    assert float(err.mean()) <= LOGIT_MEAN, (what, float(err.mean()))


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("file,cfg", [(FILE, CONFIG), (SMOKE_FILE, SMOKE)],
                         ids=["config", "smoke"])
def test_the_benchmark_file_builds_the_port_config(file, cfg):
    got = hybrid_decode.arch_config(file)
    for f in dataclasses.fields(base.ArchConfig):
        assert getattr(got, f.name) == getattr(cfg, f.name), f.name
    assert got == cfg


def test_layer_order_is_the_published_one():
    kinds = [CONFIG.layer_kind(i) for i in range(CONFIG.n_layers)]
    assert kinds == [("a" if i % 8 == 4 else "m",
                      "moe" if i % 2 == 1 else "dense") for i in range(32)]
    assert stack.n_repeats(CONFIG) == 4
    assert [(m, f) for m, _, f, _ in ref._layers(FILE)] == [
        ("attn" if a == "a" else "mamba", f) for a, f in kinds]
    assert jamba_inputs.counts(FILE) == {"attn": 4, "mamba": 28,
                                         "dense": 16, "moe": 16}


@pytest.mark.parametrize("name", base.arch_names())
def test_every_registered_config_keeps_its_layer_kinds(name):
    """The expert-layer offset is 0 everywhere but in Jamba2: MoE on
    every ``every_k``-th layer from ``first_k_dense``, as before."""
    for cfg in (base.get_arch(name), base.get_arch(name, smoke=True)):
        for li in range(cfg.n_layers):
            mixer, ffn = cfg.layer_kind(li)
            m = cfg.moe
            if m is None:
                assert ffn in ("dense", "none")
            elif li >= m.first_k_dense:
                assert (ffn == "moe") == ((li - m.first_k_dense)
                                          % m.every_k == 0)
            assert mixer == (cfg.superblock[li % len(cfg.superblock)]
                             if cfg.superblock else "a")


def test_the_card_holds_its_share():
    meta = api.init_params(CONFIG, device="meta")
    moe_p = meta["blocks"][1]["moe"]
    assert moe_p["router"].shape == (4, 4096, 16)
    assert moe_p["wi_gate"].shape == (4, 8, 4096, 14336)
    assert "conv_b" in meta["blocks"][0]["mamba"]
    assert meta["blocks"][0]["mamba"]["w_dt"].shape == (4, 256, 8192)
    n = api.param_count(CONFIG)
    assert 28.9e9 < n < 29.1e9
    assert 2 * n / 1e9 == pytest.approx(58.0, abs=0.2)


# ---------------------------------------------------------------------------
# The Mamba mixer
# ---------------------------------------------------------------------------

def _mamba_params(variant, seed=3):
    g = torch.Generator().manual_seed(seed)
    return ssm.init_mamba(g, 32, d_state=8, dt_rank=4, device="cpu",
                          variant=variant)


def test_plain_mamba_has_no_published_leaves():
    assert set(_mamba_params("plain")) == {
        "w_in", "conv_w", "w_x", "w_dt", "a_log", "d_skip", "w_out"}
    assert set(_mamba_params("jamba")) == set(
        hybrid_decode.MAMBA_LEAVES)
    with pytest.raises(ValueError):
        _mamba_params("mamba2")


@pytest.mark.parametrize("variant", ["plain", "jamba"])
def test_mamba_step_chain_continues_the_prefill_scan(variant):
    p = _mamba_params(variant)
    x = torch.randn(2, 21, 32, generator=torch.Generator().manual_seed(4)
                    ).to(torch.bfloat16)
    full, (st_full, tail_full) = ssm.mamba_prefill(p, x, d_state=8)
    state = ssm.mamba_init_state(2, 32, d_state=8, device="cpu")
    outs = []
    for t in range(x.shape[1]):
        out, state = ssm.mamba_step(p, x[:, t:t + 1], state, d_state=8)
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).float(), full.float(),
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(state[0], st_full, rtol=1e-4, atol=1e-6)
    assert torch.equal(state[1], tail_full)


def test_jamba_mixer_against_the_reference(model):
    raw, _ = model
    a = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(5))
    want = ref._mamba(raw, 0, a, SMOKE_FILE, None)
    p = {k: raw[f"mamba.{k}"][0] for k in hybrid_decode.MAMBA_LEAVES}
    got, _ = ssm.mamba_prefill(p, a.to(torch.bfloat16), d_state=8)
    err = (got.float() - want).abs()
    assert float(err.max()) <= 0.05 * float(want.abs().max())


# ---------------------------------------------------------------------------
# The MoE layer's share of the experts
# ---------------------------------------------------------------------------

def _moe_layer(raw, lo, hi, i=0):
    return {"router": raw["moe.router"][i],
            "wi_gate": raw["moe.e_gate"][i, lo:hi],
            "wi_up": raw["moe.e_up"][i, lo:hi],
            "wo": raw["moe.e_down"][i, lo:hi]}


@pytest.fixture(scope="module")
def whole():
    """The uncut layer: all 16 experts held, in the file and the tree."""
    cfg = dict(SMOKE_FILE, num_experts=16, experts_held=[0, 16])
    return cfg, jamba_inputs.make_weights(cfg, 11, "cpu")


def test_shares_add_up_to_the_whole_layer(whole):
    cfg, raw = whole
    x = torch.randn(24, 1, 64, generator=torch.Generator().manual_seed(6))
    kw = dict(top_k=2, renorm=False)
    shares = [moe.apply_moe(_moe_layer(raw, lo, hi), x, held=(lo, hi),
                            **kw)[0] for lo, hi in ((0, 8), (8, 16))]
    full = moe.apply_moe(_moe_layer(raw, 0, 16), x, **kw)[0]
    np.testing.assert_allclose(shares[0] + shares[1], full, rtol=0,
                               atol=SHARE_ATOL)
    # the uncut reference's whole layer, 24 rows as one decode batch
    # (drops included: capacity int(24 * 2 / 16 * 1.25) = 3 a expert)
    want = ref._moe(raw, 0, x, cfg, 0, 1.25, None)
    np.testing.assert_allclose(shares[0] + shares[1], want, rtol=0.02,
                               atol=0.02 * float(want.abs().max()))
    for (lo, hi), got in zip(((0, 8), (8, 16)), shares):
        held = dict(raw, **{f"moe.e_{k}": raw[f"moe.e_{k}"][:, lo:hi]
                            for k in ("gate", "up", "down")})
        part = ref._moe(held, 0, x, dict(cfg, experts_held=[lo, hi]), 0,
                        1.25, None)
        np.testing.assert_allclose(got, part, rtol=0.02,
                                   atol=0.02 * float(want.abs().max()))
    assert (shares[0] != 0).any() and (shares[1] != 0).any()


def test_gates_are_not_renormalised(whole):
    _, raw = whole
    x = torch.randn(6, 1, 64, generator=torch.Generator().manual_seed(7))
    p = _moe_layer(raw, 0, 16)
    g_pub, i_pub, _ = moe.route(p, x, 2, renorm=False)
    g_ren, i_ren, _ = moe.route(p, x, 2)
    probs = torch.softmax(x.reshape(6, 64) @ p["router"], -1)
    assert torch.equal(i_pub, i_ren)
    torch.testing.assert_close(g_pub, probs.gather(1, i_pub))
    torch.testing.assert_close(g_ren.sum(-1), torch.ones(6))


def test_the_other_dispatches_refuse_a_share(whole, monkeypatch):
    _, raw = whole
    x = torch.randn(4, 1, 64, generator=torch.Generator().manual_seed(8))
    share = _moe_layer(raw, 0, 8)
    gates, idx, _ = moe.route(share, x, 2)
    for dispatch in (moe.dispatch_dense, moe.dispatch_grouped):
        with pytest.raises(ValueError):
            dispatch(share, x, gates, idx)
    with pytest.raises(ValueError):
        moe.dispatch_dropping(share, x, gates, idx)       # no held range
    with pytest.raises(ValueError):
        moe.dispatch_dropping(share, x, gates, idx, held=(4, 16))
    for impl in ("dense", "grouped"):
        with pytest.raises(ValueError):
            moe.apply_moe(share, x, top_k=2, impl=impl, held=(0, 8))
        monkeypatch.setattr(moe, "FORCE_IMPL", impl)
        with pytest.raises(ValueError):
            moe.apply_moe(share, x, top_k=2, held=(0, 8))
        monkeypatch.setattr(moe, "FORCE_IMPL", None)


class _Ops(TorchDispatchMode):
    """The ATen ops a block issues, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _decode_ops(cfg, params, state, tokens):
    rec = _Ops()
    with rec:
        stack.decode_step(cfg, params, state, tokens)
    return rec.ops


def test_every_expert_held_issues_the_ops_of_no_share():
    """DeepSeek-MoE's decode step with ``held`` set to all its experts
    issues the same ops as with none, and a strict share only adds the
    local masks to each slot's dispatch."""
    cfg = base.get_arch("deepseek-moe-16b", smoke=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.arange(4, dtype=torch.int32)[:, None]
    # a first step fills the memos (rotary frequencies, the head's
    # float32 copy) that later steps reuse
    stack.decode_step(cfg, params,
                      api.init_decode_state(cfg, 4, 16, device="cpu"),
                      tokens)
    ops = {}
    for held in (None, (0, 8)):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             held=held))
        state = api.init_decode_state(c, 4, 16, device="cpu")
        ops[held] = _decode_ops(c, params, state, tokens)
    assert ops[None] == ops[(0, 8)]
    x = torch.randn(4, 1, 64, generator=torch.Generator().manual_seed(9))
    p = params["blocks"][0]["moe"]
    p = {k: v[0] for k, v in p.items() if k != "shared"}
    p4 = {k: (v[:4] if k != "router" else v) for k, v in p.items()}
    rec_all, rec_share = _Ops(), _Ops()
    with rec_all:
        moe.apply_moe(p, x, top_k=2)
    with rec_share:
        moe.apply_moe(p4, x, top_k=2, held=(0, 4))
    extra = collections.Counter(rec_share.ops) - collections.Counter(
        rec_all.ops)
    assert extra and set(extra) <= {
        "aten.ge.Scalar", "aten.lt.Scalar", "aten.bitwise_and.Tensor",
        "aten.sub.Tensor", "aten.where.self", "aten.scalar_tensor.default",
        "aten.select.int", "aten.lift_fresh.default"}, extra


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def test_forward_matches_the_reference(model, monkeypatch):
    """``stack.forward`` (prefill) over whole sequences: the reference
    keeps every prefill pair, so the port's capacity is lifted above
    every bucket here (the decode test holds the drops)."""
    raw, params = model
    orig = moe.dispatch_dropping
    monkeypatch.setattr(moe, "dispatch_dropping", lambda *a, **k: orig(
        *a, **dict(k, capacity_factor=64.0)))
    tokens = torch.as_tensor(lm_inputs.prompts(SMOKE_FILE, 3, 2, 12)).long()
    logits, caches = stack.forward(SMOKE, params, tokens, mode="prefill")
    _close(logits, _ref_logits(raw, tokens, 12), "forward")
    assert len(caches) == 8


def test_engine_prefill_then_decode_matches_the_reference(model,
                                                          monkeypatch):
    """Four 4-token prompts prefilled token by token through the engine,
    then 12 decode ticks of all four rows (capacity drops as the ticks
    had them): every logit the engine sampled from, against the
    reference's full forward over the served sequences."""
    raw, params = model
    seen = []
    greedy = sampler.greedy

    def spy(logits, vocab):
        seen.append(logits.detach().clone())
        return greedy(logits, vocab)

    monkeypatch.setattr(sampler, "greedy", spy)
    b, pl, ticks = 4, 4, 12
    prompts = lm_inputs.prompts(SMOKE_FILE, 4, b, pl)
    eng = Engine(SMOKE, params, batch_slots=b, max_seq=64)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=100)
            for i in range(b)]
    for r in reqs:
        eng.submit(r)
    for _ in range(ticks):
        eng.step()
    served = torch.tensor([r.out_tokens for r in reqs])
    assert served.shape == (b, ticks + 1)
    got = torch.cat([torch.cat(seen[:b])[:, None],
                     torch.stack(seen[b:], 1)], 1)
    tokens = torch.cat([torch.as_tensor(prompts).long(), served[:, :-1]], 1)
    want = _ref_logits(raw, tokens, pl)[:, pl - 1:]
    _close(got, want, "engine")
    gaps = ref.gaps(raw, SMOKE_FILE, ref.hidden(raw, SMOKE_FILE, tokens, pl,
                                                1.25), served, pl - 1)
    assert gaps["positions"] == b * (ticks + 1)
    assert gaps["max_gap"] <= harness.load_limits(
        "jamba2_decode_b64")["max_gap"]
