"""The MoE dispatch's CUDA kernels (``kernels/moe_dispatch.py``): on the
CPU, the launch plan at the cells' shapes, the engage rule, the
``serve.moe_fused`` counter on the smoke engine and in a training step,
and the benchmark's reader; on the card (marker ``gpu``, skipped without
one), the kernels against the plain ``route`` + ``dispatch_dropping``.
This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_dispatch.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import harness
from repro_torch.configs.base import get_arch
from repro_torch.kernels import dispatch
from repro_torch.kernels import moe_dispatch as md
from repro_torch.models import api, layers, moe
from repro_torch.obs import Observability
from repro_torch.serve.engine import Engine, Request

KERNEL = md.KERNEL


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

#: (E_held, C, D, F, N*K) -> (mt, route rows, route splits)
PLANS = {
    "deepseek_decode": ((64, 3, 2048, 1408, 32 * 6), (1, 256, 8)),
    "deepseek_prefill": ((64, 1, 2048, 1408, 6), (1, 256, 8)),
    "jamba_decode": ((8, 10, 4096, 14336, 64 * 2), (1, 256, 16)),
    "jamba_prefill": ((8, 1, 4096, 14336, 2), (1, 256, 16)),
    "deepseek_n256": ((64, 30, 2048, 1408, 256 * 6), (2, 256, 8)),
    "ragged": ((4, 40, 264, 520, 2048), (3, 256, 2)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_at_the_cells_shapes(case):
    args, (mt, rows, splits) = PLANS[case]
    pl = md.plan(*args)
    e_held, cap, d, f, pairs = args
    assert pl.mt == mt and pl.mt * 16 >= cap
    assert (pl.route_rows, pl.route_splits) == (rows, splits)
    assert pl.route_rows * pl.route_splits >= d
    # the ranking's experts and the route blocks' rows within the 48 KB
    # of a launch that sets no shared-memory attribute
    assert 4 * (pairs + md.MAX_EXPERTS + 256) <= pl.route_smem <= 48 * 1024
    assert md.plan(*args) is pl     # memoized


@pytest.mark.parametrize("args", [(8, 0, 64, 64, 4), (8, 65, 64, 64, 4),
                                  (8, 4, 64, 64, 4097), (8, 4, 60, 64, 4),
                                  (8, 4, 64, 68 + 2, 4)])
def test_plan_refuses_what_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        md.plan(*args)


# ---------------------------------------------------------------------------
# The engage rule
# ---------------------------------------------------------------------------

D, F, E, K = 32, 16, 8, 2


def _layer(seed=0, n_shared=1, n_held=None):
    g = torch.Generator().manual_seed(seed)
    return moe.init_moe(g, D, F, E, n_shared, device="cpu", n_held=n_held)


def _x(n, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 1, D, generator=g).to(dtype)


def _plain_launch(p, x, *, top_k, cap, share, renorm):
    """What ``md._launch`` returns, computed by the plain ``route`` +
    ``dispatch_dropping`` on the CPU: the routed experts' output (no
    shared experts), the (E,) counts and the aux loss."""
    routed = {k: v for k, v in p.items() if k != "shared"}
    gv, gi, aux = moe.route(p, x, top_k, renorm)
    with moe.expert_tally() as tally:
        out = moe.dispatch_dropping(routed, x, gv, gi, held=share)
    (counts, c, _), = tally
    assert c == cap
    return types.SimpleNamespace(out=out, counts=counts, aux=aux)


def _cpu_kernels(monkeypatch, on_card=lambda *ts: all(
        t.device == ts[0].device for t in ts)):
    """CPU tensors pass the engage rule's device test, and the launch is
    the plain dispatch's, so that the rule's other conditions and the
    wrapper's own lines (the count, the tally's entry, the shared
    experts) run here."""
    monkeypatch.setattr(md, "_on_card", on_card)
    monkeypatch.setattr(md, "_launch", _plain_launch)


@pytest.fixture
def cpu_is_a_card(monkeypatch):
    _cpu_kernels(monkeypatch)


def _grad(p, x, mp):
    p["wi_up"].requires_grad_(True)
    return p, x


def _x_grad(p, x, mp):
    return p, x.requires_grad_(True)


def _dtensor(p, x, mp):
    """``x`` read as a DTensor: ``apply_moe`` takes its sharded path and
    never asks the rule."""
    mp.setattr(moe.act, "sharded", lambda t: t is x)
    mp.setattr(moe, "_apply_moe_sharded",
               lambda p_, x_, **kw: (x_, x_.new_zeros(())))
    return p, x


def _float64(p, x, mp):
    return p, x.double()


def _strided(p, x, mp):
    p["wo"] = p["wo"].transpose(1, 2).contiguous().transpose(1, 2)
    return p, x


#: (case) -> (rows N, the call's change, apply_moe's impl, capacity
#: factor, engages)
ENGAGE = {
    "local_nograd_dropping": (16, None, "dropping", 1.25, True),
    "auto_is_dropping": (16, None, "auto", 1.25, True),
    "one_token": (1, None, "dropping", 1.25, True),
    "weights_need_grad": (16, _grad, "dropping", 1.25, False),
    "x_needs_grad": (16, _x_grad, "dropping", 1.25, False),
    "dtensor": (16, _dtensor, "dropping", 1.25, False),
    "grouped": (16, None, "grouped", 1.25, False),
    "dense": (16, None, "dense", 1.25, False),
    "pairs_over_the_limit": (md.MAX_PAIRS // K + 1, None, "dropping", 0.01,
                             False),
    "rows_over_the_limit": (64, None, "dropping", 5.0, False),
    "float64": (16, _float64, "dropping", 1.25, False),
    "strided_weights": (16, _strided, "dropping", 1.25, False),
}


@pytest.mark.parametrize("case", sorted(ENGAGE))
def test_engage_rule(case, cpu_is_a_card, monkeypatch):
    n, change, impl, cf, want = ENGAGE[case]
    p, x = _layer(), _x(n)
    if change is not None:
        p, x = change(p, x, monkeypatch)
    if impl in ("dropping", "auto") and change is not _dtensor:
        assert md.engages(p, x, K, cf) is want
    before = dispatch.count(KERNEL)
    out, aux = moe.apply_moe(p, x, top_k=K, impl=impl, capacity_factor=cf)
    assert dispatch.count(KERNEL) - before == int(want)
    assert out.shape == x.shape and aux.dim() == 0


def test_the_rule_on_cpu_tensors_is_off():
    p, x = _layer(), _x(16)
    assert not md.engages(p, x, K)
    before = dispatch.count(KERNEL)
    moe.apply_moe(p, x, top_k=K)
    assert dispatch.count(KERNEL) == before


@pytest.mark.parametrize("held", [None, (0, 4), (4, 8)])
@pytest.mark.parametrize("renorm", [True, False])
def test_the_wrapper_equals_the_plain_dispatch(held, renorm, cpu_is_a_card):
    """The wrapper around a launch that computes the plain dispatch's
    results: the same output, aux and tally entry as ``route`` +
    ``dispatch_dropping``, one launch counted and, in an open tally, one
    fused dispatch."""
    p = _layer(n_held=None if held is None else held[1] - held[0])
    x = _x(24)
    with moe.expert_tally() as t_plain:
        gv, gi, aux = moe.route(p, x, K, renorm)
        want = moe.dispatch_dropping(p, x, gv, gi, held=held)
    before = dispatch.count(KERNEL)
    with moe.expert_tally() as t_fused:
        got, aux_got = moe.apply_moe(p, x, top_k=K, held=held, renorm=renorm)
    assert dispatch.count(KERNEL) - before == 1
    assert torch.equal(got, want) and torch.equal(aux_got, aux)
    assert t_plain.fused == 0 and t_fused.fused == 1
    (c0, cap0, h0), = t_plain
    (c1, cap1, h1), = t_fused
    assert torch.equal(c0, c1) and (cap0, h0) == (cap1, h1)
    assert cap1 == md.capacity(24, K, E, 1.25)


# ---------------------------------------------------------------------------
# serve.moe_fused on the smoke engine and in a training step
# ---------------------------------------------------------------------------

SLOTS, TICKS = 4, 3


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_arch("deepseek-moe-16b", smoke=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(3),
                             device="cpu")
    return cfg, params


def _serve(cfg, params, o):
    eng = Engine(cfg, params, batch_slots=SLOTS, max_seq=32, obs=o)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 3),
                    max_new_tokens=64) for i in range(SLOTS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(TICKS):
        eng.step()
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("engaged", [False, True])
def test_fused_counter_on_the_smoke_engine(moe_model, engaged, monkeypatch):
    cfg, params = moe_model
    plain = _serve(cfg, params, Observability.create(mirror_events=False))
    if engaged:
        _cpu_kernels(monkeypatch, lambda *ts: True)
    o = Observability.create(mirror_events=False)
    before = dispatch.count(KERNEL)
    assert _serve(cfg, params, o) == plain
    reg = o.registry
    ticks = reg.counter("serve.moe_layer_ticks").value
    n_moe = sum(k == "moe" for _, k in map(cfg.layer_kind,
                                            range(cfg.n_layers)))
    assert ticks == n_moe * TICKS
    assert reg.counter("serve.moe_fused").value == (ticks if engaged else 0)
    # the prefills' one-token steps take the kernels too, untallied
    launches = dispatch.count(KERNEL) - before
    assert launches == (n_moe * (TICKS + SLOTS * 3) if engaged else 0)


def test_fused_counter_stays_zero_in_a_training_step(moe_model, monkeypatch):
    cfg, params = moe_model
    _cpu_kernels(monkeypatch, lambda *ts: True)
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in torch.utils._pytree.tree_leaves(params)]
    trainable = torch.utils._pytree.tree_unflatten(
        leaves, torch.utils._pytree.tree_structure(params))
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    before = dispatch.count(KERNEL)
    with moe.expert_tally() as tally:
        loss = api.loss_fn(cfg)(trainable, batch)
        loss.backward()
    assert torch.isfinite(loss)
    assert len(tally) > 0 and tally.fused == 0
    assert dispatch.count(KERNEL) == before


# ---------------------------------------------------------------------------
# The benchmark's reader
# ---------------------------------------------------------------------------

READER = "moe_fused_share.lm"


@pytest.mark.parametrize("fused,ticks,want", [(54, 54, 100.0),
                                              (27, 54, 50.0),
                                              (0, 54, 0.0),
                                              (None, 54, None),
                                              (None, 0, None)])
def test_fused_share_reader(fused, ticks, want, monkeypatch):
    from portbench.metrics import _program

    o = Observability.create(mirror_events=False)
    # this bundle alone: other tests' bundles may still be alive
    monkeypatch.setattr(_program, "bundles", lambda: [o])
    reg = o.registry
    if ticks:
        reg.counter("serve.moe_layer_ticks").inc(ticks)
    if fused is not None:
        reg.counter("serve.moe_fused").inc(fused)
    read = harness.load_metric(READER).read
    assert read({}) is None
    assert read({"window": {"tokens": 1}}) == want


def test_fused_share_is_listed_for_the_deepseek_cell():
    man = harness.manifest()
    m, = [m for m in man["per_layer"] if m["name"] == READER]
    assert m["moves"] == "tokens_per_s" and m["unit"] == "%"
    assert m["layer"] == "MoE dispatch (models/moe.py dispatch_dropping)"
    assert "moe_decode_b32" in m["workloads"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_layer(d, f, e, n_shared, held, seed, dev, skew=False):
    g = torch.Generator().manual_seed(seed)
    n_held = e if held is None else held[1] - held[0]
    p = moe.init_moe(g, d, f, e, n_shared, device="cpu", n_held=n_held)
    if skew:
        # every token's first choice on expert 1: a large router weight on
        # a dimension that every token's row holds positive
        p["router"][0, 1] = 50.0
    return {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(dev)) for k, v in p.items()}


#: (N, K, E, D, F, shared, held, renorm, x dtype, skew)
CARD = {
    "deepseek_decode": (32, 6, 64, 2048, 1408, 2, None, True, "f32", False),
    "deepseek_prefill": (1, 6, 64, 2048, 1408, 2, None, True, "f32", False),
    "jamba_decode": (64, 2, 16, 4096, 14336, 0, (0, 8), False, "f32", False),
    "drop_heavy": (32, 2, 8, 256, 512, 0, None, True, "f32", True),
    "sparse_buckets": (5, 2, 4, 264, 520, 1, (2, 4), True, "bf16", False),
    "two_row_tiles": (96, 4, 16, 512, 256, 0, None, True, "bf16", False),
}


def _plain(p, x, k, held, renorm):
    """The plain dispatch's routing, positions, keep masks, counts and
    output, under the LM's precision scope."""
    e = p["router"].shape[-1]
    share = moe._share(p, held)
    n = x.shape[0] * x.shape[1]
    cap = md.capacity(n, k, e, 1.25)
    with layers.lm_precision():
        gv, gi, aux = moe.route(p, x, k, renorm)
        with moe.expert_tally() as tally:
            out = moe.dispatch_dropping(p, x, gv, gi, held=held)
        pos, keep = moe._positions(gi, e, cap)
    pos, keep = torch.stack(pos, -1), torch.stack(keep, -1)
    lo, hi = share or (0, e)
    keep = keep & (gi >= lo) & (gi < hi)
    return dict(gate=gv, idx=gi, pos=pos, keep=keep, counts=tally[0][0],
                aux=aux, out=out, cap=cap, share=share)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD))
def test_kernels_against_the_plain_dispatch(case):
    dev = _cuda()
    n, k, e, d, f, shared, held, renorm, xd, skew = CARD[case]
    p = _card_layer(d, f, e, shared, held, 11, dev, skew)
    g = torch.Generator().manual_seed(12)
    x = torch.randn(n, 1, d, generator=g)
    if skew:
        x[..., 0] = x[..., 0].abs() + 0.5
    x = x.to(dev, torch.bfloat16 if xd == "bf16" else torch.float32)
    want = _plain(p, x, k, held, renorm)
    with layers.lm_precision(), moe.expert_tally() as tally:
        before = dispatch.count(KERNEL)
        got, aux = moe.apply_moe(p, x, top_k=k, held=held, renorm=renorm)
        assert dispatch.count(KERNEL) - before == 1
        r = md._launch(p, x, top_k=k, cap=want["cap"], share=want["share"],
                       renorm=renorm)
    v = md.views(r)
    torch.cuda.synchronize()
    assert torch.equal(v["idx"], want["idx"])
    assert torch.equal(v["keep"], want["keep"])
    assert torch.equal(torch.where(v["keep"], v["pos"], 0),
                       torch.where(want["keep"], want["pos"], 0))
    assert torch.equal(v["pos"], want["pos"])
    assert torch.equal(v["counts"], want["counts"])
    (counts, cap, share), = tally
    assert torch.equal(counts, want["counts"]) and cap == want["cap"]
    assert tally.fused == 1
    # the table holds each kept pair's token at its expert and position
    table = torch.full_like(v["table"], -1)
    lo = (want["share"] or (0, e))[0]
    for tok, kk in want["keep"].nonzero().tolist():
        table[int(want["idx"][tok, kk]) - lo, int(want["pos"][tok, kk])] = tok
    assert torch.equal(v["table"], table)
    # gates and aux from the kernel's own float32 router sums: within a
    # few float32 ulps of cuBLAS's order
    torch.testing.assert_close(v["gate"], want["gate"], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(aux, want["aux"], rtol=1e-5, atol=1e-7)
    # the output: the experts' GEMMs accumulate in another order than
    # cuBLAS's, so g, u, h and y may each round to the neighbouring bf16
    # value (2**-8 relative); two such steps (h into the down product, y)
    # bound an element by 2 bf16 ulps of the layer's scale
    assert got.dtype == x.dtype
    scale = want["out"].float().abs().max()
    err = (got.float() - want["out"].float()).abs()
    assert float(err.max()) <= 2 * 2 ** -8 * float(scale)
    assert torch.isfinite(got).all()


@pytest.mark.gpu
def test_deepseek_shapes_sync_free_and_grad_takes_the_plain_path(
        monkeypatch):
    dev = _cuda()
    p = _card_layer(2048, 1408, 64, 2, None, 3, dev)
    x = torch.randn(32, 1, 2048, device=dev)
    moe.apply_moe(p, x, top_k=6)                 # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = dispatch.count(KERNEL)
        moe.apply_moe(p, x, top_k=6)
        assert dispatch.count(KERNEL) - before == 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    p["wi_gate"].requires_grad_(True)
    before = dispatch.count(KERNEL)
    out, aux = moe.apply_moe(p, x, top_k=6)
    assert dispatch.count(KERNEL) == before and out.requires_grad
    p["wi_gate"].requires_grad_(False)
    plan = md.plan
    monkeypatch.setattr(md, "plan", lambda *a: plan(*a)._replace(mt=5))
    with pytest.raises(RuntimeError, match="launch failed"):    # no such tile
        moe.apply_moe(p, x, top_k=6)
