"""The Jamba2 decode tick's spans and counters: ``mamba.proj``,
``mamba.scan`` and ``mamba.out`` under each ``layer.mamba``, each Mamba
layer's ``mamba.state`` write-back under the tick's issue, and the MoE
counters of a layer that holds a share of its experts (``serve.moe_local``
beside ``serve.moe_assigned``) against a host recount of the routing."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import hybrid_decode
from portbench.inputs import jamba as jamba_inputs
from repro_torch.configs.jamba2_mini import SMOKE
from repro_torch.models import moe
from repro_torch.obs import Observability
from repro_torch.serve.engine import Engine, Request

SLOTS, TICKS = 8, 3
MAMBA_KIDS = ("mamba.proj", "mamba.scan", "mamba.out")
MOE_KIDS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
SMOKE_FILE = harness.load_json(harness.BENCH / "tests" / "data"
                               / "jamba2_mini_smoke.json")


@pytest.fixture(scope="module")
def params():
    raw = jamba_inputs.make_weights(SMOKE_FILE, 5, "cpu")
    return hybrid_decode.port_params(raw, SMOKE_FILE)


def _serve(params, o):
    eng = Engine(SMOKE, params, batch_slots=SLOTS, max_seq=32, obs=o)
    rng = np.random.default_rng(5)
    for i in range(SLOTS):
        eng.submit(Request(rid=i, prompt=rng.integers(0, SMOKE.vocab, 3),
                           max_new_tokens=64))
    for _ in range(TICKS):
        eng.step()


def _children(spans, parent):
    return sorted((s for s in spans if s["parent"] == parent["id"]),
                  key=lambda s: s["t0"])


def test_decode_tick_tree(params):
    o = Observability.create(mirror_events=False)
    _serve(params, o)
    spans = o.trace.spans()
    want = ["embed"]
    for li in range(SMOKE.n_layers):
        mixer, ffn = SMOKE.layer_kind(li)
        want += ["layer.attn" if mixer == "a" else "layer.mamba",
                 "layer.moe" if ffn == "moe" else "layer.mlp"]
        if mixer == "m":
            want.append("mamba.state")
    want.append("head")
    ticks = [s for s in spans if s["name"] == "decode"]
    assert len(ticks) == TICKS
    for tick in ticks:
        issue = _children(spans, tick)[0]
        assert issue["name"] == "decode.issue"
        kids = _children(spans, issue)
        assert [k["name"] for k in kids] == want
        for k in kids:
            names = tuple(c["name"] for c in _children(spans, k))
            if k["name"] == "layer.mamba":
                assert names == MAMBA_KIDS
            elif k["name"] == "layer.moe":
                assert names == MOE_KIDS
            else:
                assert names == ()
    # a prefill runs the same step, token by token, under its span
    for pre in (s for s in spans if s["name"] == "prefill"):
        names = [k["name"] for k in _children(spans, pre)]
        assert names.count("mamba.state") == 7 * 3
        assert names.count("layer.mamba") == 7 * 3


def test_moe_counters_equal_a_host_recount(params, monkeypatch):
    routed = []
    route = moe.route

    def spy(p, x, top_k, renorm=True):
        out = route(p, x, top_k, renorm=renorm)
        routed.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "route", spy)
    o = Observability.create(mirror_events=False)
    _serve(params, o)
    e, k = SMOKE.moe.n_experts, SMOKE.moe.top_k
    lo, hi = SMOKE.moe.held
    ticks = [idx for idx in routed if idx.shape[0] == SLOTS]
    assert len(ticks) == 4 * TICKS
    want = dict(assigned=0, local=0, kept=0, rows=0, experts_hit=0)
    for idx in ticks:
        cap = max(1, int(SLOTS * k / e * 1.25))
        _, keep = moe._positions(idx, e, cap)
        held = (idx >= lo) & (idx < hi)
        want["assigned"] += idx.numel()
        want["local"] += int(held.sum())
        want["kept"] += int((torch.stack(keep, -1) & held).sum())
        want["rows"] += (hi - lo) * cap
        want["experts_hit"] += int(torch.unique(idx[held]).numel())
    reg = o.registry
    got = {n: reg.counter(f"serve.moe_{n}").value for n in want}
    assert got == want
    assert 0 < got["local"] < got["assigned"]
    assert reg.counter("serve.moe_layer_ticks").value == len(ticks)


def test_a_disabled_bundle_records_nothing(params):
    o = Observability.create(enabled=False, mirror_events=False)
    _serve(params, o)
    assert len(o.trace) == 0
    assert not [n for n in o.registry.names() if "moe" in n]
