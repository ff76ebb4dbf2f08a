"""The port's spans and counters: the tracer's parent links and
``obs.span``, ingest's and a join's phases in the KWS scheduler, the LM
tick's tree down to the MoE dispatch, the expert tally against a host
recount, and the benchmark's readers of them on small CPU cells."""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import _cells
from repro_torch import obs
from repro_torch.configs.base import get_arch
from repro_torch.models import api, moe
from repro_torch.obs import Observability, coverage
from repro_torch.serve.engine import Engine, Request
from repro_torch.stream.scheduler import JOIN_PHASES, PUSH_PHASES

HOP_PHASES = ("pack", "dispatch", "device", "detector", "push_fold")


def _bundle(enabled: bool = True) -> Observability:
    return Observability.create(enabled=enabled, mirror_events=False)


def _by_name(spans: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _children(spans: list[dict], parent: dict) -> list[dict]:
    return sorted((s for s in spans if s["parent"] == parent["id"]),
                  key=lambda s: s["t0"])


def _tiles(spans: list[dict], parent: dict, names: tuple) -> float:
    """Assert the children of ``parent`` are ``names``, back to back from
    its start and inside it -> the share of it they cover."""
    kids = _children(spans, parent)
    assert tuple(k["name"] for k in kids) == names
    assert kids[0]["t0"] == parent["t0"]
    for a, b in zip(kids, kids[1:]):
        assert b["t0"] == pytest.approx(a["t0"] + a["dur_s"], abs=1e-9)
    end = kids[-1]["t0"] + kids[-1]["dur_s"]
    assert end <= parent["t0"] + parent["dur_s"] + 1e-9
    return sum(k["dur_s"] for k in kids) / parent["dur_s"]


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

def test_spans_link_to_their_parents():
    o = _bundle()
    tr = o.trace
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            tr.add("stamped", time.perf_counter(), 1e-6)
        with tr.span("tiled") as tiled:
            ph = tiled.phases(("a", "b"))
            ph.mark()
            ph.mark()
        ph.record()
    top = tr.add("top", time.perf_counter(), 1e-6)
    tr.add_batch((("x", time.perf_counter(), 1e-6, {}),
                  ("y", time.perf_counter(), 1e-6, {})), parent=top)
    by = {s["name"]: s for s in tr.spans()}
    assert by["outer"]["parent"] is None and by["top"]["parent"] is None
    assert by["inner"]["parent"] == outer.id == by["outer"]["id"]
    assert by["stamped"]["parent"] == inner.id
    assert by["tiled"]["parent"] == outer.id
    assert by["a"]["parent"] == by["b"]["parent"] == tiled.id
    assert by["x"]["parent"] == by["y"]["parent"] == top
    assert len({s["id"] for s in tr.spans()}) == len(tr) == 9
    assert _tiles(tr.spans(), by["tiled"], ("a", "b")) <= 1.0


def test_add_batch_takes_the_open_span_as_parent():
    o = _bundle()
    with o.trace.span("push") as sp:
        o.trace.add_batch((("k", time.perf_counter(), 0.0, {}),))
    assert o.trace.spans("k")[0]["parent"] == sp.id


def test_obs_span_records_into_the_innermost_scope():
    a, b = _bundle(), _bundle()
    with a.trace.span("a.scope"):
        with obs.span("in.a"):
            pass
        with b.trace.span("b.scope"):
            with obs.span("in.b"):
                pass
        with obs.span("in.a.again"):
            pass
    assert [s["name"] for s in a.trace.spans()] == [
        "in.a", "in.a.again", "a.scope"]
    assert [s["name"] for s in b.trace.spans()] == ["in.b", "b.scope"]
    scope = a.trace.spans("a.scope")[0]["id"]
    assert {s["parent"] for s in a.trace.spans()} == {scope, None}
    assert b.trace.spans("b.scope")[0]["parent"] is None


def test_obs_span_is_a_no_op_without_a_scope_or_when_disabled():
    assert obs.span("nowhere") is obs.span("elsewhere")
    with obs.span("nowhere"):
        pass
    on, off = _bundle(), _bundle(enabled=False)
    with on.trace.span("outer"):
        with off.trace.span("disabled") as sp:
            assert sp.id is None
            with obs.span("model"):
                pass
            sp.phases(("p",)).mark()
    assert len(off.trace) == 0
    assert off.trace.add("x", 0.0, 1.0) is None
    assert [s["name"] for s in on.trace.spans()] == ["outer"]


def test_live_lists_bundles_in_order_of_creation():
    a, b = _bundle(), _bundle()
    got = obs.live()
    assert got.index(a) < got.index(b)
    ident = id(b)
    del b, got
    gc.collect()
    assert ident not in {id(o) for o in obs.live()}


# ---------------------------------------------------------------------------
# KWS ingest and joins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kws_cell():
    """The KWS cell at the CPU tests' size, set up and run for a short
    window (its scheduler's bundle holds the spans)."""
    wl, config, traffic = _cells.small("kws_saturated")
    cell = harness.load_driver(traffic["driver"]).Cell(
        config, traffic, 2 ** 40 + 17, "cpu",
        harness.load_limits(wl["name"]))
    cell.setup()
    cell.window(0.3)
    yield cell
    cell.release()


def test_push_and_join_phases_tile_their_spans(kws_cell):
    spans = kws_cell.sched.obs.trace.spans()
    by = _by_name(spans)
    pushes, joins = by["push"], by["join"]
    assert len(joins) == kws_cell.n
    assert len(pushes) == 1 + kws_cell.traffic["warm_rounds"] + len(
        kws_cell.stats["push_s"])
    push_cov = [_tiles(spans, p, PUSH_PHASES) for p in pushes]
    join_cov = [_tiles(spans, j, JOIN_PHASES) for j in joins]
    assert statistics.median(push_cov) >= 0.95
    assert statistics.median(join_cov) >= 0.95
    for name in PUSH_PHASES + JOIN_PHASES:
        assert len(by[name]) == len(by[name.split(".")[0]])


def test_every_round_lands_by_block_rows(kws_cell):
    """The set-up's first push (prime and hop 1) goes flat; every warm
    and window round lands each stream's hop by the arena's block path."""
    reg = kws_cell.sched.obs.registry
    rounds = kws_cell.traffic["warm_rounds"] + len(kws_cell.stats["push_s"])
    assert reg.counter("stream.push_block_rows").value == kws_cell.n * rounds
    assert reg.counter("stream.push_rows").value == kws_cell.n * (1 + rounds)


def test_hop_phases_unchanged_under_their_hop(kws_cell):
    spans = kws_cell.sched.obs.trace.spans()
    by = _by_name(spans)
    for hop in by["hop"]:
        kids = _children(spans, hop)
        assert tuple(k["name"] for k in kids) == HOP_PHASES
    assert coverage(spans) >= 0.95
    assert set(kws_cell.sched.metrics.phase_summary()) == {
        "pack", "dispatch", "device", "detector"}
    assert "device_ms_p50" not in kws_cell.sched.metrics.summary()


# ---------------------------------------------------------------------------
# The LM tick
# ---------------------------------------------------------------------------

SLOTS, TICKS = 4, 3


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_arch("deepseek-moe-16b", smoke=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(3),
                             device="cpu")
    return cfg, params


def _serve(cfg, params, o, ticks=TICKS, asyn=False):
    eng = Engine(cfg, params, batch_slots=SLOTS, max_seq=32, obs=o)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 3),
                    max_new_tokens=64) for i in range(SLOTS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(ticks):
        eng.step_async() if asyn else eng.step()
    if asyn:
        eng.shutdown()
    return [list(r.out_tokens) for r in reqs]


MOE_KIDS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
            "moe.shared")


def test_decode_tick_tree(moe_model):
    cfg, params = moe_model
    o = _bundle()
    _serve(cfg, params, o)
    spans = o.trace.spans()
    by = _by_name(spans)
    n_moe = sum(k == "moe" for _, k in map(cfg.layer_kind,
                                            range(cfg.n_layers)))
    assert len(by["decode"]) == TICKS
    for tick in by["decode"]:
        kids = _children(spans, tick)
        assert [k["name"] for k in kids] == [
            "decode.issue", "decode.sample", "decode.fence"]
        assert sum(k["dur_s"] for k in kids) <= tick["dur_s"]
        issue = _children(spans, kids[0])
        names = [k["name"] for k in issue]
        assert names[0] == "embed" and names[-1] == "head"
        assert names.count("layer.attn") == cfg.n_layers
        assert names.count("layer.mlp") == cfg.moe.first_k_dense
        assert names.count("layer.moe") == n_moe == 2
        for layer in (k for k in issue if k["name"] == "layer.moe"):
            assert tuple(k["name"] for k in _children(spans, layer)) == \
                MOE_KIDS
    # each prefill runs the same step, token by token, under its span
    for pre in by["prefill"]:
        kids = [k["name"] for k in _children(spans, pre)]
        assert kids.count("embed") == 3 and kids.count("layer.moe") == 6
    assert all(s["parent"] is not None for s in by["layer.moe"])


def test_async_tick_splits_dispatch_and_retire(moe_model):
    cfg, params = moe_model
    o = _bundle()
    _serve(cfg, params, o, asyn=True)
    spans = o.trace.spans()
    by = _by_name(spans)
    for d in by["decode_dispatch"]:
        assert [k["name"] for k in _children(spans, d)] == [
            "decode.issue", "decode.sample"]
    for r in by["decode_retire"]:
        assert [k["name"] for k in _children(spans, r)] == ["decode.fence"]
    assert len(by["decode_retire"]) == len(by["decode_dispatch"]) == TICKS
    reg = o.registry
    assert reg.counter("serve.moe_layer_ticks").value == 2 * TICKS


def test_expert_counters_equal_a_host_recount(moe_model, monkeypatch):
    cfg, params = moe_model
    routed = []
    route = moe.route

    def spy(p, x, top_k):
        out = route(p, x, top_k)
        routed.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "route", spy)
    o = _bundle()
    _serve(cfg, params, o)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    # prefill routes one token at a time; a decode tick every slot's
    ticks = [idx for idx in routed if idx.shape[0] == SLOTS]
    assert len(ticks) == 2 * TICKS
    want = dict(assigned=0, kept=0, rows=0, hit=0)
    for idx in ticks:
        cap = max(1, int(SLOTS * k / e * 1.25))
        _, keep = moe._positions(idx, e, cap)
        want["assigned"] += idx.numel()
        want["kept"] += int(sum(m.sum() for m in keep))
        want["rows"] += e * cap
        want["hit"] += int(torch.unique(idx).numel())
    reg = o.registry
    got = {n: reg.counter(f"serve.moe_{c}").value for n, c in (
        ("assigned", "assigned"), ("kept", "kept"), ("rows", "rows"),
        ("hit", "experts_hit"))}
    assert got == want
    assert reg.counter("serve.moe_layer_ticks").value == len(ticks)


def test_disabled_bundle_records_nothing_and_serves_alike(moe_model):
    cfg, params = moe_model
    on, off = _bundle(), _bundle(enabled=False)
    assert _serve(cfg, params, on) == _serve(cfg, params, off)
    assert len(off.trace) == 0
    assert not [n for n in off.registry.names() if "moe" in n]
    assert off.registry.histogram("serve.decode_tick_s").count == TICKS


def test_tally_counts_gathered_rows_once():
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, 16, 8, 8, device="cpu")
    xs = list(torch.randn(4, 1, 16, generator=g).chunk(2))
    with moe.expert_tally() as tally:
        moe.apply_moe_gathered([p, p], xs, top_k=2)
        with moe._tally_paused():
            moe.apply_moe(p, xs[0], top_k=2)
    assert len(tally) == 1 and int(tally[0][0].sum()) == 4 * 2
    assert tally[0][1] == max(1, int(4 * 2 / 8 * 1.25))
    moe.apply_moe(p, xs[0], top_k=2)   # no tally open: nothing kept


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------

NEW = {"kws_saturated": ("push_resolve_ms.kws", "push_stage_ms.kws",
                         "push_index_ms.kws", "push_scatter_ms.kws",
                         "join_ms.kws", "push_block_share.kws"),
       "moe_decode_b32": ("tick_issue_ms.lm", "tick_fence_ms.lm",
                          "attn_issue_ms.lm", "moe_issue_ms.lm",
                          "experts_hit.lm", "moe_row_fill.lm",
                          "prefill_ms.lm")}


def _readers(workload):
    man = harness.manifest()
    per = {m["name"]: m for m in harness.cell_metrics(man, workload,
                                                      "per_layer")}
    assert set(NEW[workload]) <= set(per)
    return [per[n] for n in NEW[workload]]


@pytest.mark.parametrize("workload", sorted(NEW))
def test_new_readers_find_nothing_in_an_empty_context(workload):
    for m in _readers(workload):
        assert harness.load_metric(m["name"]).read({}) is None
        assert harness.load_metric(m["name"]).read(
            {"window": {}, "trace": None}) is None


def test_kws_readers_on_a_small_cell(kws_cell):
    got = harness.read_metrics(_readers("kws_saturated"),
                               kws_cell.context())
    assert set(got) == set(NEW["kws_saturated"])
    assert all(math.isfinite(v["value"]) and v["value"] > 0
               for v in got.values())


def test_lm_readers_on_a_small_cell():
    wl, config, traffic = _cells.small("moe_decode_b32")
    cell = harness.load_driver(traffic["driver"]).Cell(
        config, traffic, 2 ** 40 + 19, "cpu",
        harness.load_limits(wl["name"]))
    cell.setup()
    cell.window(0.3)
    try:
        got = harness.read_metrics(_readers("moe_decode_b32"),
                                   cell.context())
    finally:
        cell.release()
    assert set(got) == set(NEW["moe_decode_b32"])
    assert all(math.isfinite(v["value"]) for v in got.values())
    assert 0 < got["moe_row_fill.lm"]["value"] <= 100
    assert 0 < got["experts_hit.lm"]["value"] <= config["n_routed_experts"]
