"""The port's KWS training (``repro_torch.core.quant``'s straight-through
quantizers, ``models.kws``' QAT graph and export, ``train/``, ``data/``,
``utils/tree``) against the reference's on the same inputs, at the smoke
spec (``in_len`` 800, width 16), batch 4.

The port cannot draw ``jax.random``, so every case carries the
reference's params across as numpy (``params_from_numpy``); batches come
from ``gscd`` (numpy in both packages).  Tolerances, each stated where it
is used:
  * forward logits, export, STE values and the quantizers' gradients:
    equal, bit for bit (the QAT forward is integer arithmetic in float32);
  * loss: 1e-6 relative; gradients: rtol 1e-4 and atol 1e-6 x max |g|
    (float32 sums in another order);
  * optimizer state, compression and metrics: rtol 1e-6, atol 1e-6 x
    the leaf's max |value| (element-wise float32 math, and float32 means
    that round an ulp apart);
  * five training steps: losses within 1e-5 relative and masters within
    atol 1e-6, with no ternary weight different after export.
Everything runs on CPU tensors (``device="cpu"``); the deploy's kernels
run their plain versions there and count their launches as on the card.
"""
import pathlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_cases import port_spec
from repro.core import quant as ref_quant
from repro.data import gscd as ref_gscd
from repro.models import kws as ref_kws
from repro.train import compression as ref_comp
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro.train import schedule as ref_sched
from repro_torch.core import compiler, quant
from repro_torch.core.executor import Executor
from repro_torch.data import gscd
from repro_torch.kernels import dispatch
from repro_torch.models import kws
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression, loop, optimizer, schedule
from repro_torch.utils import tree

SPEC = ref_kws.build_kws_smoke_spec()
PSPEC = port_spec(SPEC)
CPU = torch.device("cpu")
B = 4

_ref_fwd = jax.jit(jax.vmap(lambda p, x: ref_kws.kws_forward(p, x, SPEC),
                            in_axes=(None, 0)))
_ref_vg = jax.jit(jax.value_and_grad(
    lambda p, x, y: ref_kws.kws_loss(p, x, y, SPEC)))


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _ref_params(seed=0, perturb=False):
    """The reference's init; with ``perturb``, random affines: some a < 0,
    two a == 0 (b >= 0 and b < 0) per layer, b spread over the STE
    window, and temp 0.7."""
    p = _np(ref_kws.init_kws_params(jax.random.PRNGKey(seed), SPEC))
    if perturb:
        rng = np.random.default_rng(seed + 100)
        for key, entry in p.items():
            if key == "temp" or "a" not in entry:
                continue
            n = entry["a"].shape[0]
            a = entry["a"] * rng.uniform(-0.5, 2.0, n)
            a[:2] = 0
            b = rng.uniform(-1, 1, n).astype(np.float32)
            b[:2] = [0.25, -0.25]
            entry["a"], entry["b"] = a.astype(np.float32), b
        p["temp"] = np.float32(0.7)
    return p


def _batch(step, seed=0, b=B):
    return gscd.batch(seed=seed, step=step, batch_size=b, n=SPEC.in_len)


def _grads(params_np, x, y):
    """The port's loss and gradient tree at ``params_np``."""
    pp = kws.params_from_numpy(params_np, CPU)
    return loop.value_and_grad(
        lambda p, bt: kws.kws_loss(p, *bt, PSPEC), pp,
        (torch.as_tensor(x), torch.as_tensor(y)))


def _near_delta(w):
    """Weights within one float32 ulp of the ternary threshold (where the
    two packages' float32 means could round apart)."""
    w = np.asarray(w, np.float32)
    delta = np.float32(0.05) * np.mean(np.abs(w), dtype=np.float32)
    return int(np.sum(np.abs(np.abs(w) - delta)
                      <= np.spacing(np.float32(delta))))


# ---------------------------------------------------------------------------
# Straight-through estimators
# ---------------------------------------------------------------------------

def test_binarize_act_values_and_gradient():
    """Equal, bit for bit, including x at exactly 0 and +-1, one ulp
    either side of +-1, and the smallest normal floats either side of 0
    (XLA on the CPU flushes subnormals to zero, so they are left out)."""
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float32).tiny
    edges = np.float32([0.0, -0.0, 1.0, -1.0, tiny, -tiny])
    ulp = (np.nextafter(edges[2:4], np.float32(2)),
           np.nextafter(edges[2:4], np.float32(-2)))
    x = np.concatenate([rng.normal(0, 1.5, 200).astype(np.float32), edges,
                        *ulp])
    c = rng.normal(size=x.shape).astype(np.float32)
    want, g_want = jax.value_and_grad(
        lambda v: jnp.sum(ref_quant.binarize_act(v) * c))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = quant.binarize_act(xt)
    (out * torch.as_tensor(c)).sum().backward()
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(ref_quant.binarize_act(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_want))
    assert float(want) == pytest.approx(
        float((out.detach() * torch.as_tensor(c)).sum()), rel=1e-6)


@pytest.mark.parametrize("case", ["at_delta", "random"])
def test_ternarize_weight_values_and_gradient(case):
    """Equal, bit for bit; ``at_delta`` puts weights at exactly +-delta
    (|w| = 1, 1, 39, 39: mean 20, delta 0.05 * 20 = 1.0 in float32), which
    ternarize to 0.  The gradient is the identity and ``threshold_scale``
    gets none."""
    rng = np.random.default_rng(1)
    if case == "at_delta":
        w = np.float32([[1.0, -1.0], [39.0, -39.0]])
    else:
        w = rng.normal(0, 0.1, (5, 16, 32)).astype(np.float32)
    c = rng.normal(size=w.shape).astype(np.float32)
    want = np.asarray(ref_quant.ternarize_weight(jnp.asarray(w)))
    g_want = jax.grad(lambda v: jnp.sum(ref_quant.ternarize_weight(v) * c))(
        jnp.asarray(w))
    wt = torch.as_tensor(w).requires_grad_(True)
    out = quant.ternarize_weight(wt)
    (out * torch.as_tensor(c)).sum().backward()
    np.testing.assert_array_equal(
        out.detach().numpy(), want,
        err_msg=f"{_near_delta(w)} weights within an ulp of delta")
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(g_want))
    if case == "at_delta":
        np.testing.assert_array_equal(want, [[0, 0], [1, -1]])


# ---------------------------------------------------------------------------
# The QAT forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,perturb", [(0, False), (1, False), (2, True)])
def test_kws_forward_bit_exact(seed, perturb):
    """The batched forward equals the reference's ``vmap``'d per-example
    forward bit for bit, and its pre-activations are integers; the params
    go across and back through numpy unchanged."""
    p = _ref_params(seed, perturb)
    x, _ = _batch(seed)
    want = np.asarray(_ref_fwd(p, jnp.asarray(x)))
    pre = []
    pp = kws.params_from_numpy(p, CPU)
    back = kws.params_to_numpy(pp)
    for a, b in zip(jax.tree_util.tree_leaves(p), tree.tree_leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    got = kws.kws_forward(pp, torch.as_tensor(x), PSPEC, preacts=pre)
    assert got.shape == (B, 12) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=str(
        [_near_delta(e["w"]) for k, e in p.items() if k != "temp"]))
    assert len(pre) == 6
    for s in pre:
        assert torch.equal(s, s.round())


@pytest.mark.parametrize("seed,perturb", [(0, False), (2, True)])
def test_kws_loss_and_gradients(seed, perturb):
    """Loss within 1e-6 relative; every gradient leaf within rtol 1e-4,
    atol 1e-6 x the leaf's max |g| (float32 sums in another order)."""
    p = _ref_params(seed, perturb)
    x, y = _batch(seed + 10)
    loss_w, g_w = _ref_vg(p, jnp.asarray(x), jnp.asarray(y))
    loss, g = _grads(p, x, y)
    assert float(loss) == pytest.approx(float(loss_w), rel=1e-6)
    leaves_w = jax.tree_util.tree_leaves(g_w)
    leaves = tree.tree_leaves(g)
    assert len(leaves) == len(leaves_w) == 17
    for a, b in zip(leaves_w, leaves):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(a).max()))


def test_maxpool_ties_split_the_gradient():
    """``amax`` splits the gradient among tied maxima as ``jnp.max`` does:
    windows [1, 1], [0, 1], [0, 0] take [.5, .5], [0, 2], [1.5, 1.5] of
    upstream 1, 2, 3 (``max_pool1d`` would give [1, 0], [0, 2], [3, 0])."""
    h = torch.tensor([[[1.0], [1.0], [0.0], [1.0], [0.0], [0.0]]],
                     requires_grad=True)
    out = kws._maxpool(h, 2)
    (out[0, :, 0] * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    np.testing.assert_array_equal(h.grad[0, :, 0].numpy(),
                                  [0.5, 0.5, 0, 2, 1.5, 1.5])
    g_ref = jax.grad(lambda v: jnp.sum(
        ref_kws._maxpool(v, 2)[:, 0] * jnp.float32([1, 2, 3])))(
        jnp.asarray(h.detach().numpy()[0]))
    np.testing.assert_array_equal(h.grad.numpy()[0], np.asarray(g_ref))


def test_kws_gradients_through_tied_pools():
    """Every binary conv's affine forced to a = 1e-4, b = 0.5: a * s + b
    stays inside (0, 1], so the outputs are all 1 inside the STE window
    and every pool window ties.  The gradients of ``a`` (sums of upstream
    gradient x s over the positions the pool sends it to) and of l0's
    weights (reached through three tied pools) still agree with the
    reference (tolerance as above)."""
    p = _ref_params(3)
    for li in (1, 2, 3):
        p[f"layer{li}"]["a"] = np.full_like(p[f"layer{li}"]["a"], 1e-4)
        p[f"layer{li}"]["b"] = np.full_like(p[f"layer{li}"]["b"], 0.5)
    x, y = _batch(3)
    _, g_w = _ref_vg(p, jnp.asarray(x), jnp.asarray(y))
    _, g = _grads(p, x, y)
    for li in (0, 1, 2, 3):
        assert np.abs(np.asarray(g_w[f"layer{li}"]["w"])).max() > 0
        assert np.abs(np.asarray(g_w[f"layer{li}"]["a"])).max() > 0
    for a, b in zip(jax.tree_util.tree_leaves(g_w), tree.tree_leaves(g)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(a).max()))


def test_kws_accuracy_and_module():
    """``kws_accuracy`` equals the reference's; ``KWSQAT`` holds the
    reference's keys, its forward is ``kws_forward`` and its autograd
    gradients equal ``value_and_grad``'s."""
    p = _ref_params(4, perturb=True)
    x, y = _batch(4, b=8)
    pp = kws.params_from_numpy(p, CPU)
    acc = kws.kws_accuracy(pp, torch.as_tensor(x), torch.as_tensor(y), PSPEC)
    want = ref_kws.kws_accuracy(p, jnp.asarray(x), jnp.asarray(y), SPEC)
    assert float(acc) == float(want)
    model = kws.KWSQAT(PSPEC, kws.params_from_numpy(p, CPU))
    names = {n for n, _ in model.named_parameters()}
    assert "temp" in names and "layers.layer0.w" in names
    assert "layers.layer6.w" in names and "layers.layer6.a" not in names
    xt = torch.as_tensor(x)
    assert torch.equal(model(xt), kws.kws_forward(pp, xt, PSPEC))
    loss = torch.nn.functional.cross_entropy(model(xt) * model.temp,
                                             torch.as_tensor(y).long())
    loss.backward()
    want_loss, g = _grads(p, x, y)
    assert torch.equal(loss.detach(), want_loss)
    assert torch.equal(model.layers["layer5"]["w"].grad, g["layer5"]["w"])


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,perturb", [(0, False), (2, True)])
def test_export_bit_exact(seed, perturb):
    """int8 ternary weights, float64 thresholds (+-inf where a == 0) and
    flips (a < 0) equal the reference's."""
    p = _ref_params(seed, perturb)
    w_ref, t_ref = ref_kws.export_kws(p, SPEC)
    w, t = kws.export_kws(kws.params_from_numpy(p, CPU), PSPEC)
    assert sorted(w) == sorted(w_ref) and sorted(t) == sorted(t_ref)
    for li in w_ref:
        assert w[li].dtype == np.int8
        np.testing.assert_array_equal(w[li], np.asarray(w_ref[li]))
        assert t[li][0].dtype == np.float64 and t[li][1].dtype == bool
        np.testing.assert_array_equal(t[li][0], np.asarray(t_ref[li][0]))
        np.testing.assert_array_equal(t[li][1], np.asarray(t_ref[li][1]))
    if perturb:
        thr = t[1][0]
        assert thr[0] == -np.inf and thr[1] == np.inf and t[1][1].any()


# ---------------------------------------------------------------------------
# Optimizers, schedule, compression
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.normal(0, 0.1, (3, 4, 5)).astype(np.float32),
            "layer": {"a": rng.normal(0, 1, 6).astype(np.float32),
                      "m": rng.normal(0, 1, (7, 2)).astype(np.float32)},
            "temp": np.float32(0.3)}


def _close(got, want, rtol=1e-6):
    for a, b in zip(jax.tree_util.tree_leaves(want), tree.tree_leaves(got)):
        a = np.asarray(a, np.float32)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=1e-6 * float(np.abs(a).max()))


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("name", ["adamw", "sgd", "lion", "adafactor"])
def test_optimizer_update(name, clip):
    """Three updates from the same state and gradients (scaled so clipping
    bites at clip 1.0), lr_scale from the schedule: master, moments,
    grad_norm and lr within rtol 1e-6."""
    rng = np.random.default_rng(5)
    params = _opt_tree(rng)
    cfg_w = ref_opt.OptConfig(name=name, lr=1e-2, clip_norm=clip)
    cfg = optimizer.OptConfig(name=name, lr=1e-2, clip_norm=clip)
    st_w = ref_opt.init_opt_state(cfg_w, params)
    st = optimizer.init_opt_state(cfg, kws.params_from_numpy(params, CPU))
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: (rng.normal(0, 3, np.shape(x))).astype(np.float32),
            params)
        scale_w = ref_sched.warmup_cosine(i, warmup_steps=2, total_steps=5)
        scale = schedule.warmup_cosine(i, warmup_steps=2, total_steps=5)
        st_w, m_w = ref_opt.update(cfg_w, st_w, g, scale_w)
        st, m = optimizer.update(cfg, st, kws.params_from_numpy(g, CPU),
                                 scale)
        assert sorted(st) == sorted(st_w)
        assert int(st["step"]) == int(st_w["step"]) == i + 1
        for key in st_w:
            if key != "step":
                _close(st[key], st_w[key])
        assert float(m["grad_norm"]) == pytest.approx(
            float(m_w["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(m_w["lr"]), rel=1e-6)
    template = kws.params_from_numpy(params, CPU)
    template["w"] = template["w"].to(torch.bfloat16)
    cast = optimizer.cast_params_like(st["master"], template)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["temp"].dtype == torch.float32


def test_schedule_matches_reference():
    """``warmup_cosine`` within rtol 1e-6 at steps across warm-up, the
    cosine and past its end; ``constant`` is 1."""
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        got = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                     warmup_steps=10, total_steps=100)
        want = ref_sched.warmup_cosine(step, warmup_steps=10,
                                       total_steps=100)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    assert schedule.constant(3) == ref_sched.constant(3) == 1.0


@pytest.mark.parametrize("scheme", ["sign1bit", "topk"])
def test_compression_matches_reference(scheme):
    """Two transforms: compressed gradients and the error-feedback state
    within rtol 1e-6 of the reference's; compressed + residual equals the
    corrected gradient (nothing is lost); ``compressed_bytes`` equal."""
    rng = np.random.default_rng(6)
    g = _opt_tree(rng)
    t_w = ref_comp.make_transform(scheme, topk_frac=0.25)
    t = compression.make_transform(scheme, topk_frac=0.25)
    st_w, st = {}, {}
    gt = kws.params_from_numpy(g, CPU)
    for _ in range(2):
        ef = st.get("ef")
        c_w, st_w = t_w(g, st_w)
        c, st = t(gt, st)
        _close(c, c_w)
        _close(st["ef"], st_w["ef"])
        corrected = gt if ef is None else tree.tree_map(torch.add, gt, ef)
        for a, b, e in zip(tree.tree_leaves(corrected), tree.tree_leaves(c),
                           tree.tree_leaves(st["ef"])):
            torch.testing.assert_close(b + e, a, rtol=1e-6, atol=1e-7)
    if scheme == "topk":
        assert int((c["w"] != 0).sum()) == 15   # 25 % of 60
    for s in ("sign1bit", "topk", "none"):
        assert compression.compressed_bytes(gt, s, 0.25) == \
            ref_comp.compressed_bytes(g, s, 0.25)
    assert compression.make_transform("none") is None


def test_optimizer_with_compression():
    """AdamW with the sign1bit hook: master and moments within the
    optimizer tolerance of the reference's after two updates.  Like the
    reference's ``update``, the port's keeps no ``"ef"`` in the state it
    returns, so the residual does not reach the next update there."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    cfg_w = ref_opt.OptConfig(lr=1e-2)
    cfg = optimizer.OptConfig(lr=1e-2)
    st_w = ref_opt.init_opt_state(cfg_w, params)
    st = optimizer.init_opt_state(cfg, kws.params_from_numpy(params, CPU))
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32),
            params)
        st_w, _ = ref_opt.update(cfg_w, st_w, g,
                                 grad_transform=ref_comp.make_transform())
        st, _ = optimizer.update(cfg, st, kws.params_from_numpy(g, CPU),
                                 grad_transform=compression.make_transform())
    assert sorted(st) == sorted(st_w) == ["m", "master", "step", "v"]
    for key in ("master", "m", "v"):
        _close(st[key], st_w[key])


def test_tree_helpers():
    """Leaves in the reference's order (sorted keys), sizes, counts and
    the global norm (rtol 1e-6)."""
    rng = np.random.default_rng(8)
    t_np = {"b": [rng.normal(size=3).astype(np.float32),
                  (np.int32(4), np.zeros((2, 2), np.float32))],
            "a": {"z": rng.normal(size=(2, 3)).astype(np.float32),
                  "y": None}}
    t = kws.params_from_numpy(t_np, CPU)
    want = jax.tree_util.tree_leaves(t_np)
    got = tree.tree_leaves(t)
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tree.tree_count_params(t) == 3 + 1 + 4 + 6
    assert tree.tree_size_bytes(t) == 4 * (3 + 1 + 4 + 6)
    assert float(tree.global_norm(t)) == pytest.approx(
        float(ref_opt.global_norm(t_np)), rel=1e-6)
    z = tree.tree_zeros_like(t)
    assert z["a"]["y"] is None and isinstance(z["b"][1], tuple)
    assert all(float(v.abs().sum()) == 0 for v in tree.tree_leaves(z))
    with pytest.raises(ValueError):
        tree.tree_map(torch.add, t, {"a": 1})


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _ref_train(params, steps, tcfg_w):
    step = jax.jit(ref_loop.make_train_step(
        None, tcfg_w, lambda p, bt: ref_kws.kws_loss(p, *bt, SPEC)))
    state = ref_loop.init_train_state(tcfg_w, jax.tree_util.tree_map(
        jnp.asarray, params))
    losses = []
    for i in range(steps):
        x, y = _batch(i)
        state, m = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(m["loss"]))
    return state, losses


def _train_cfgs(**kw):
    opt = dict(lr=2e-3, clip_norm=1.0)
    sched = dict(warmup_steps=1, total_steps=10)
    return (ref_loop.TrainConfig(opt=ref_opt.OptConfig(**opt), remat="none",
                                 **sched, **kw),
            loop.TrainConfig(opt=optimizer.OptConfig(**opt), **sched, **kw))


def test_five_training_steps_match_reference():
    """Five AdamW steps (lr 2e-3, clip 1.0, warm-up 1 of 10) from the
    reference's params on the same batches, through each package's
    ``make_train_step``: losses within 1e-5 relative, masters within atol
    1e-6 (updates are ~lr x O(1); float32 gradient sums differ in the last
    bits), and no ternary weight different after export."""
    tcfg_w, tcfg = _train_cfgs()
    params = _ref_params(0)
    state_w, losses_w = _ref_train(params, 5, tcfg_w)
    step = loop.make_train_step(
        None, tcfg, lambda p, bt: kws.kws_loss(p, *bt, PSPEC))
    state = loop.init_train_state(tcfg, kws.params_from_numpy(params, CPU))
    losses = []
    for i in range(5):
        x, y = _batch(i)
        state, m = step(state, (torch.as_tensor(x), torch.as_tensor(y)))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, losses_w, rtol=1e-5)
    assert int(state["opt"]["step"]) == 5
    for a, b in zip(jax.tree_util.tree_leaves(state_w["opt"]["master"]),
                    tree.tree_leaves(state["opt"]["master"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    w_ref, _ = ref_kws.export_kws(state_w["params"], SPEC)
    w, _ = kws.export_kws(state["params"], PSPEC)
    differ = sum(int((w[li] != np.asarray(w_ref[li])).sum()) for li in w)
    assert differ == 0, f"{differ} ternary weights differ after export"


def test_microbatches_equal_full_batch():
    """``microbatches=2`` over the batch split in two equals one full
    batch (the contract of ``tests/test_train.py``, held here to loss
    rtol 1e-6 and masters atol 1e-7)."""
    params = kws.params_from_numpy(_ref_params(1), CPU)
    x, y = _batch(0, b=8)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    out = []
    for mb in (1, 2):
        _, tcfg = _train_cfgs(microbatches=mb)
        step = loop.make_train_step(
            None, tcfg, lambda p, bt: kws.kws_loss(p, *bt, PSPEC))
        batch = (xt, yt) if mb == 1 else (xt.reshape(2, 4, -1),
                                          yt.reshape(2, 4))
        out.append(step(loop.init_train_state(tcfg, params), batch))
    (s1, m1), (s2, m2) = out
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for a, b in zip(tree.tree_leaves(s1["opt"]["master"]),
                    tree.tree_leaves(s2["opt"]["master"])):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed,step,n", [(0, 0, 800), (0, 3, 16000),
                                         (7, 10_000, 800), (123, 5, 4000)])
def test_gscd_batches_identical(seed, step, n):
    """The same (seed, step) gives the same bytes in both packages."""
    x_w, y_w = ref_gscd.batch(seed, step, 3, n=n)
    x, y = gscd.batch(seed, step, 3, n=n)
    assert x.dtype == np.uint8 and y.dtype == np.int32
    np.testing.assert_array_equal(x, x_w)
    np.testing.assert_array_equal(y, y_w)


def test_straggler_monitor_matches_reference():
    """The same flags, time for time, on a run where host 3 slows down."""
    rng = np.random.default_rng(9)
    mon_w = ref_loop.StragglerMonitor(4, factor=2.0)
    mon = loop.StragglerMonitor(4, factor=2.0)
    flags = []
    for i in range(20):
        t = rng.uniform(0.9, 1.1, 4)
        if i >= 5:
            t[3] = 8.0
        got = mon.record(t)
        assert got == mon_w.record(t)
        flags.append(got)
    assert flags[0] == [] and flags[-1] == [3]


# ---------------------------------------------------------------------------
# Checkpoints and the trainer
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_exact(tmp_path):
    """Every leaf back bit for bit with its dtype and shape (bfloat16, a
    0-d int32, bool, an empty tensor) and the meta."""
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": [torch.randn(4).to(torch.bfloat16),
               torch.tensor(7, dtype=torch.int32)],
         "c": (torch.tensor([True, False]), torch.zeros(0, 3)),
         "d": None}
    ckpt.save(tmp_path, 7, t, meta={"x": 1})
    step, back, meta = ckpt.restore(tmp_path, t)
    assert step == 7 and meta == {"x": 1} and back["d"] is None
    assert isinstance(back["b"], list) and isinstance(back["c"], tuple)
    for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1).view(torch.uint8)
                           if a.dtype == torch.bfloat16 else a,
                           b.view(-1).view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoint_gc_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, {"x": torch.ones(3)}, keep_last=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert sorted(p.name for p in pathlib.Path(tmp_path).glob("step-*")) == [
        "step-0000000004", "step-0000000005"]
    assert not list(pathlib.Path(tmp_path).glob("tmp-*"))
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", {"x": torch.ones(3)})


def test_checkpoint_corruption_detected(tmp_path):
    """A flipped byte in a leaf fails its crc32 (IOError); a flipped byte
    in the compressed file fails to decompress (IOError); a template with
    another leaf count raises ValueError."""
    t = {"x": torch.arange(100.0), "y": torch.ones(3)}
    p = ckpt.save(tmp_path, 1, t)
    raw = bytearray(zlib.decompress(p.read_bytes()))
    raw[-20] ^= 0xFF                              # inside leaf "y"'s bytes
    p.write_bytes(zlib.compress(bytes(raw)))
    with pytest.raises(IOError, match="CRC"):
        ckpt.restore(tmp_path, t)
    p = ckpt.save(tmp_path, 2, t)
    blob = bytearray(p.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    p.write_bytes(bytes(blob))
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, t)
    ckpt.save(tmp_path, 3, t)
    with pytest.raises(ValueError, match="architecture mismatch"):
        ckpt.restore(tmp_path, {"x": torch.zeros(100)})


def _trainer(ckpt_dir, steps_cfg=4):
    _, tcfg = _train_cfgs(ckpt_dir=str(ckpt_dir), ckpt_every=steps_cfg)
    batches = (tuple(map(torch.as_tensor, _batch(i))) for i in range(100))
    return loop.Trainer(PSPEC, tcfg,
                        lambda p, bt: kws.kws_loss(p, *bt, PSPEC),
                        kws.params_from_numpy(_ref_params(0), CPU), batches)


def test_restart_resumes_training(tmp_path):
    """A trainer checkpointing every 4 steps runs 8; a new one on the same
    directory resumes at step 8 with the saved state, bit for bit; its
    history carries the step count and a positive step time."""
    tr = _trainer(tmp_path)
    hist = tr.run(8)
    assert [h["step"] for h in hist] == list(range(1, 9))
    assert all(h["step_time_s"] > 0 and np.isfinite(h["loss"])
               for h in hist)
    assert ckpt.latest_step(tmp_path) == 8
    tr2 = _trainer(tmp_path)
    assert tr2.step_idx == 8
    for a, b in zip(tree.tree_leaves(tr.state), tree.tree_leaves(tr2.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Deploy on the CPU, and the device rule
# ---------------------------------------------------------------------------

def test_deploy_after_training_on_cpu():
    """Three training steps, then ``export_kws``; ``offline_logits`` on a
    ``prepare_offline`` model (1 B.3, 3 B.6, 2 B.7 launches a clip) and
    the compiled program through the executor (one launch a MAC chunk)
    equal ``kws_forward`` bit for bit on three clips."""
    _, tcfg = _train_cfgs()
    step = loop.make_train_step(
        None, tcfg, lambda p, bt: kws.kws_loss(p, *bt, PSPEC))
    state = loop.init_train_state(tcfg, kws.params_from_numpy(_ref_params(0),
                                                              CPU))
    for i in range(3):
        state, _ = step(state, tuple(map(torch.as_tensor, _batch(i))))
    params = state["params"]
    weights, thresholds = kws.export_kws(params, PSPEC)
    x, _ = gscd.batch(seed=7, step=10_000, batch_size=3, n=SPEC.in_len)
    qat = kws.kws_forward(params, torch.as_tensor(x), PSPEC)
    assert torch.equal(qat, qat.round())
    model = kws.prepare_offline(PSPEC, weights, thresholds, device="cpu")
    prog = compiler.compile_model(PSPEC, weights, thresholds, device="cpu")
    n_mac = sum(k == "mac" for k, _ in prog.instr_meta)
    for clip, want in zip(x, qat.to(torch.int64)):
        with dispatch.counting() as launched:
            off = kws.offline_logits(model, torch.as_tensor(clip))
        assert sum(launched().values()) == 6
        assert torch.equal(off.to(torch.int64), want)
        with dispatch.counting() as launched:
            rep = Executor(prog).run(clip[:, None])
        assert sum(launched().values()) == n_mac
        assert torch.equal(rep.output.ravel().to(torch.int64), want)


def test_training_entry_points_need_a_device():
    """Without ``device``, the entry points go to the card, and raise when
    there is none; ``device="cpu"`` runs here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kws.init_kws_params(PSPEC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kws.params_from_numpy(_ref_params(0))
    p = kws.init_kws_params(PSPEC, device="cpu")
    assert p["layer0"]["w"].shape == (19, 1, 16)
    assert p["layer0"]["w"].dtype == torch.float32
    assert float(p["temp"]) == pytest.approx(0.3)
    ref = _ref_params(0)
    assert sorted(p) == sorted(ref)
    for key in p:
        if key != "temp":
            assert sorted(p[key]) == sorted(ref[key])
            for k in p[key]:
                assert p[key][k].shape == ref[key][k].shape
    np.testing.assert_array_equal(p["layer1"]["a"].numpy(), ref["layer1"]["a"])
    np.testing.assert_array_equal(p["layer5"]["a"].numpy(), ref["layer5"]["a"])
    again = kws.init_kws_params(
        PSPEC, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layer2"]["w"], p["layer2"]["w"])
    w = p["layer2"]["w"]
    assert abs(float(w.std()) * np.sqrt(5 * 32) - 1) < 0.05
