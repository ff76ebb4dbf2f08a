"""The port's MoE, SSM/xLSTM, hybrid and encoder-decoder families
(``repro_torch.models.{moe,ssm,encdec}``, ``cross_attention`` and their
branches in ``stack``, ``api`` and the engine) against the reference's on
the CPU.

The smoke configs of ``deepseek-moe-16b``, ``llama4-scout-17b-a16e``
(moe), ``xlstm-350m`` (ssm), ``jamba-1.5-large-398b`` (hybrid) and
``seamless-m4t-medium`` (encdec) run with the reference's params carried
over through ``api.params_from_numpy``: the train-mode forward and its
aux loss, the prefill (logits, caches and recurrent states), 8 decode
steps, decode against forward (the reference's
``test_prefill_decode_consistency``, with ``FORCE_IMPL = "dense"``) and
the engine sync and async.  The pieces run on the same inputs as the
reference's: the router, each MoE dispatch on the reference's own
routing, mLSTM chunked and sequential, the prefill-then-step contract of
mLSTM, sLSTM and Mamba (the reference's ``tests/test_ssm.py``), the
Mamba chunk scan, the state shapes, ``encode`` and ``cross_attention``.

Tolerances: logits within ``rtol=LOGIT_RTOL, atol=LOGIT_ATOL`` of the
reference's and bf16 caches and float32 states within ``STATE_RTOL,
STATE_ATOL``, as in ``tests/test_torch_lm.py``: XLA's and PyTorch's
transcendentals differ in the last float32 bit, and Mamba's chunk scan
combines in another order than XLA's ``associative_scan``.  The whole
models are held to the reference run op by op (``jax.disable_jit``),
which rounds every bf16 intermediate as the port does, and to its
compiled run within the reference's own decode/forward bound
(``REF_RTOL, REF_ATOL``): XLA fuses the scanned superblock and drops
some of those roundings, and on jamba's smoke config the compiled
reference's logits differ from its op-by-op ones by up to 0.092, beyond
``LOGIT_ATOL`` (the port's differ from the op-by-op ones by ~5e-7).  The
pieces are held tighter, at the reference's own bounds in
``tests/test_ssm.py`` or exactly: the dropping dispatch with identity
experts is data movement and a float32 combine in the reference's
order, so it must be bit-equal.
Engine tokens are exact or, at the first differing step of a request, a
near tie of the reference's logits (``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serve as serve
from repro.configs import base as ref_base
from repro.models import api as ref_api
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import stack as ref_stack
from repro.sharding import act as ref_act
from repro_torch.configs import base as port_base
from repro_torch.launch.mesh import make_stream_mesh
from repro_torch.models import api, encdec, moe, ssm, stack
from repro_torch.models import attention as port_attn
from repro_torch.serve import engine
from repro_torch.utils.tree import tree_leaves

LOGIT_RTOL, LOGIT_ATOL = 0.02, 0.08
STATE_RTOL, STATE_ATOL = 0.02, 0.05
#: the reference's own decode-vs-forward bound (tests/test_models.py)
REF_RTOL, REF_ATOL = 0.06, 0.15

FAMILIES = [n for n in ref_base.arch_names()
            if ref_base.get_arch(n).family in ("moe", "ssm", "hybrid",
                                               "encdec")]
STACKED = [n for n in FAMILIES if ref_base.get_arch(n).family != "encdec"]
ENCDEC = "seamless-m4t-medium"
#: the engine's families (the reference's engine tests name jamba and
#: xlstm; deepseek-moe is the full-width model, seamless the encdec one)
ENGINE = ["deepseek-moe-16b", "xlstm-350m", "jamba-1.5-large-398b", ENCDEC]
B, S, N_DECODE = 2, 16, 8


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x) -> np.ndarray:
    return x.detach().to(torch.float32).numpy()


def close(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL, what=""):
    np.testing.assert_allclose(_t(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def equal(got, want, what=""):
    np.testing.assert_array_equal(_t(got), _np(want), err_msg=what)


def to_port(x, dtype=None) -> torch.Tensor:
    """A JAX array as a CPU tensor of its dtype (bf16 exactly)."""
    t = torch.as_tensor(np.array(_np(x)))
    return t.to(dtype or (torch.bfloat16 if x.dtype == jnp.bfloat16
                          else torch.float32))


def port_tree(cfg, ref_params):
    return api.params_from_numpy(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), ref_params),
        device="cpu")


def like_params(p: dict) -> dict:
    """A reference sub-tree (one layer's params) as port tensors, each
    leaf in the reference's dtype."""
    return jax.tree_util.tree_map(to_port, p)


class Case:
    """One smoke config: both packages' configs, the reference's params
    and the port's copy, tokens and (encdec) frame embeddings."""

    def __init__(self, name: str):
        self.ref_cfg = ref_base.get_arch(name, smoke=True)
        self.cfg = port_base.get_arch(name, smoke=True)
        self.ref_params = ref_api.init_params(self.ref_cfg,
                                              jax.random.PRNGKey(0))
        self.params = port_tree(self.cfg, self.ref_params)
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(
            np.int32)
        self.frames = rng.standard_normal((B, S, self.cfg.d_model)).astype(
            np.float32)

    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def ref_frames(self):
        return jnp.asarray(self.frames).astype(jnp.bfloat16)

    def port_frames(self):
        return torch.as_tensor(self.frames).to(torch.bfloat16)

    def memories(self):
        """Both packages' encoder memory of the frames (encdec)."""
        return (ref_encdec.encode(self.ref_cfg, self.ref_params,
                                  self.ref_frames()),
                encdec.encode(self.cfg, self.params, self.port_frames()))

    @property
    def ref_prefill(self):
        """The reference's prefill of the tokens (logits, caches), op by
        op, made once."""
        if not hasattr(self, "_ref_prefill"):
            with jax.disable_jit():
                self._ref_prefill = ref_api.prefill_fn(self.ref_cfg)(
                    self.ref_params, {"tokens": jnp.asarray(self.tokens)})
        return self._ref_prefill

    def decode_both(self, n, max_seq=S):
        """n decode steps in both packages, the reference's op by op
        (encdec: the state's memory is ``encode(frames)``) -> [(ref, port)
        logits], both final states."""
        ref_state = ref_api.init_decode_state(self.ref_cfg, B, max_seq)
        state = api.init_decode_state(self.cfg, B, max_seq, device="cpu")
        if self.encdec:
            ref_mem, mem = self.memories()
            ref_state["memory"] = ref_mem
            state["memory"] = mem
        ref_dec = ref_api.decode_fn(self.ref_cfg)
        dec = api.decode_fn(self.cfg)
        out = []
        for t in range(n):
            col = self.tokens[:, t % S:t % S + 1]
            with jax.disable_jit():
                a, ref_state = ref_dec(self.ref_params, ref_state,
                                       jnp.asarray(col))
            b, state = dec(self.params, state, torch.as_tensor(col))
            out.append((a, b))
        return out, ref_state, state


_CASES: dict = {}


def case(name: str) -> Case:
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


def same_tree(got, want, rtol=STATE_RTOL, atol=STATE_ATOL, what=""):
    """Port tree (tensors) against the reference's (arrays): structure,
    shapes, dtypes and values within the tolerance."""
    g = tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape, (what, i)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (what, i)
        close(a, b, rtol, atol, f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# The weight bridge and init
# ---------------------------------------------------------------------------

def _ref_shapes(name: str):
    return jax.eval_shape(
        lambda k: ref_api.init_params(ref_base.get_arch(name, smoke=True),
                                      k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))


@pytest.mark.parametrize("name", ref_base.arch_names())
def test_params_from_numpy_dtypes_match_reference(name):
    """Every leaf takes the reference's dtype, from float32 arrays: the
    float32 router, ``w_if``, ``skip_gamma``, sLSTM ``w_in`` / ``r_in``
    and Mamba ``conv_w`` / ``w_dt`` / ``a_log`` / ``d_skip`` among them
    (sLSTM's ``w_in`` is float32, Mamba's bf16: no key rule can tell)."""
    cfg = port_base.get_arch(name, smoke=True)
    want = _ref_shapes(name)
    got = api.params_from_numpy(cfg, jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32), want), device="cpu")
    paths = jax.tree_util.tree_leaves_with_path(want)
    leaves = tree_leaves(got)
    assert len(leaves) == len(paths)
    for (path, w), g in zip(paths, leaves):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    assert {str(w.dtype) for _, w in paths} <= {"float32", "bfloat16"}


def test_params_from_numpy_refuses_another_shape():
    cfg = port_base.get_arch("xlstm-350m", smoke=True)
    tree = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                  _ref_shapes("xlstm-350m"))
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="shape"):
        api.params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_tree_matches_reference(name):
    cfg = port_base.get_arch(name, smoke=True)
    got = api.init_params(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    again = api.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    want = _ref_shapes(name)
    g_leaves = tree_leaves(got)
    assert [tuple(a.shape) for a in g_leaves] == [
        a.shape for a in jax.tree_util.tree_leaves(want)]
    assert jax.tree_util.tree_structure(api.params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(g_leaves, tree_leaves(again)):
        assert torch.equal(a, b)
    for blk in got.get("blocks", []):
        if "mamba" in blk:
            a_log = blk["mamba"]["a_log"]
            torch.testing.assert_close(
                a_log, torch.log(torch.arange(1., cfg.d_state + 1)).expand(
                    a_log.shape), rtol=0, atol=0)
    assert api.param_count(cfg) == sum(a.numel() for a in g_leaves)


# ---------------------------------------------------------------------------
# MoE: the router and each dispatch
# ---------------------------------------------------------------------------

E_MOE, K_MOE, D_MOE, F_MOE = 8, 2, 32, 48


def _moe(seed=0, shared=True, n=(2, 16)):
    """The reference's MoE params and a bf16 input, and the port's
    copies."""
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(seed), D_MOE, F_MOE, E_MOE,
                             n_shared=1 if shared else 0)
    x = jax.random.normal(jax.random.PRNGKey(seed + 10),
                          (*n, D_MOE)).astype(jnp.bfloat16)
    return ref_p, x, like_params(ref_p), to_port(x)


@pytest.mark.parametrize("seed", range(3))
def test_router_matches_reference(seed):
    """Gates and experts equal the reference's except at a near tie: where
    an index differs, the reference's probabilities of the two experts
    are within ``TIE`` of each other."""
    TIE = 1e-6
    ref_p, x, p, xt = _moe(seed, n=(4, 32))
    want_v, want_i, want_aux = ref_moe._router(ref_p, x, K_MOE)
    got_v, got_i, aux = moe.route(p, xt, K_MOE)
    want_i = np.asarray(want_i)
    probs = np.asarray(jax.nn.softmax(
        x.reshape(-1, D_MOE).astype(jnp.float32) @ ref_p["router"], -1))
    differ = np.flatnonzero((got_i.numpy() != want_i).any(-1))
    for row in differ:
        gap = np.abs(probs[row, got_i[row].numpy()] - probs[row, want_i[row]])
        assert gap.max() <= TIE, (row, gap)
    keep = np.setdiff1d(np.arange(want_i.shape[0]), differ)
    assert keep.size >= want_i.shape[0] - 2
    np.testing.assert_array_equal(got_i.numpy()[keep], want_i[keep])
    np.testing.assert_allclose(got_v.numpy()[keep], np.asarray(want_v)[keep],
                               rtol=1e-6, atol=1e-7)
    assert got_v.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_router_keeps_the_lower_expert_at_a_tie():
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    p = {"router": torch.zeros(D_MOE, E_MOE)}
    _, idx, _ = moe.route(p, torch.ones(1, 3, D_MOE, dtype=torch.bfloat16),
                          3)
    assert idx.tolist() == [[0, 1, 2]] * 3


@pytest.mark.parametrize("impl", ["dropping", "grouped", "dense"])
def test_dispatch_matches_reference(impl):
    """Each dispatch on the reference's own routing: no near tie of the
    router can flip an expert, so only the experts' bf16 arithmetic
    differs."""
    ref_p, x, p, xt = _moe(1)
    want, _ = ref_moe.apply_moe(ref_p, x, top_k=K_MOE, impl=impl)
    vals, idx, _ = ref_moe._router(ref_p, x, K_MOE)
    vals, idx = to_port(vals), torch.as_tensor(np.array(idx)).long()
    fn = {"dropping": moe.dispatch_dropping, "grouped": moe.dispatch_grouped,
          "dense": moe.dispatch_dense}[impl]
    got = fn(p, xt, vals, idx)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    close(got, want, 0.02, 0.02, impl)


def _identity_experts(monkeypatch):
    for mod in (ref_moe, moe):
        monkeypatch.setattr(mod, "_expert_mlp", lambda p, xe, q="none": xe)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 0.25])
def test_dropping_dispatch_is_exact(capacity_factor, monkeypatch):
    """With identity experts the dropping dispatch is the scatter into
    (E, C, D), the capacity rule and the gate-weighted float32 gather:
    bit-equal to the reference's, tokens dropped included (factors below
    1 drop many)."""
    _identity_experts(monkeypatch)
    ref_p, x, p, xt = _moe(2, shared=False, n=(3, 20))
    want, _ = ref_moe.apply_moe(ref_p, x, top_k=K_MOE, impl="dropping",
                                capacity_factor=capacity_factor)
    vals, idx, _ = ref_moe._router(ref_p, x, K_MOE)
    got = moe.dispatch_dropping(
        p, xt, to_port(vals), torch.as_tensor(np.array(idx)).long(),
        capacity_factor=capacity_factor)
    equal(got, want)
    if capacity_factor < 1:
        assert bool((got == 0).all(-1).any())      # some tokens dropped


@pytest.mark.parametrize("groups", [1, 2, 4, 3])
def test_grouped_dispatch_matches_reference_groups(groups, monkeypatch):
    """The reference takes its group count from its sharding policy's
    ``dp`` axis (patched here to ``groups``); the port from the argument.
    3 groups do not divide the 40 tokens, so both fall back to 1."""
    monkeypatch.setattr(ref_act, "axis_size",
                        lambda name: groups if name == "dp" else None)
    monkeypatch.setattr(ref_act, "constrain", lambda x, *a: x)
    ref_p, x, p, xt = _moe(3, n=(2, 20))
    want, _ = ref_moe.apply_moe(ref_p, x, top_k=K_MOE, impl="grouped",
                                capacity_factor=0.5)
    vals, idx, _ = ref_moe._router(ref_p, x, K_MOE)
    got = moe.dispatch_grouped(p, xt, to_port(vals),
                               torch.as_tensor(np.array(idx)).long(),
                               capacity_factor=0.5, groups=groups)
    close(got, want, 0.02, 0.02)


def test_force_impl_is_read_at_call_time(monkeypatch):
    """``FORCE_IMPL`` overrides ``impl`` at every call; ``auto`` is the
    dropping dispatch."""
    _, _, p, xt = _moe(4)
    vals, idx, aux = moe.route(p, xt, K_MOE)
    dense = moe.dispatch_dense(p, xt, vals, idx)
    drop = moe.dispatch_dropping(p, xt, vals, idx)
    out, a = moe.apply_moe(p, xt, top_k=K_MOE)
    assert torch.equal(out, drop) and torch.equal(a, aux)
    monkeypatch.setattr(moe, "FORCE_IMPL", "dense")
    assert torch.equal(moe.apply_moe(p, xt, top_k=K_MOE,
                                     impl="dropping")[0], dense)
    monkeypatch.setattr(moe, "FORCE_IMPL", "grouped")
    assert torch.equal(moe.apply_moe(p, xt, top_k=K_MOE)[0],
                       moe.dispatch_grouped(p, xt, vals, idx))
    monkeypatch.setattr(moe, "FORCE_IMPL", None)
    with pytest.raises(ValueError, match="dispatch"):
        moe.apply_moe(p, xt, top_k=K_MOE, impl="sparse")


# ---------------------------------------------------------------------------
# SSM: mLSTM, sLSTM, Mamba
# ---------------------------------------------------------------------------

KEY = jax.random.PRNGKey(0)


def _mlstm(d=32, h=4):
    ref_p = ref_ssm.init_mlstm(KEY, d, h)
    return ref_p, like_params(ref_p)


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_mlstm_chunked_matches_sequential(chunk):
    """The chunked prefill at chunk 8, 32 and 64 against the reference's
    sequential scan, at the reference's own bound (tests/test_ssm.py),
    and against the reference's chunked prefill at the same chunk."""
    ref_p, p = _mlstm()
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 32)) * 0.5
    xt = to_port(x)
    got, (c, n, m) = ssm.mlstm_prefill(p, xt, n_heads=4, chunk=chunk)
    want, want_st = ref_ssm.mlstm_prefill_sequential(ref_p, x, n_heads=4)
    close(got, want, 1e-2, 1e-3)
    close(c, want_st[0], 1e-3, 1e-4)
    same, same_st = ref_ssm.mlstm_prefill(ref_p, x, n_heads=4, chunk=chunk)
    close(got, same, 1e-2, 1e-3)
    for a, b in zip((c, n, m), same_st):
        close(a, b, 1e-3, 1e-4)
    seq, seq_st = ssm.mlstm_prefill_sequential(p, xt, n_heads=4)
    close(seq, want, 1e-2, 1e-3)
    for a, b in zip(seq_st, want_st):
        close(a, b, 1e-3, 1e-4)


def test_mlstm_prefill_then_step_continues():
    ref_p, p = _mlstm(16, 2)
    x = jax.random.normal(jax.random.PRNGKey(3), (1, 33, 16))
    xt = to_port(x)
    full, _ = ssm.mlstm_prefill(p, xt, n_heads=2, chunk=8)
    _, st = ssm.mlstm_prefill(p, xt[:, :32], n_heads=2, chunk=8)
    out, new = ssm.mlstm_step(p, xt[:, 32:], st, n_heads=2)
    np.testing.assert_allclose(_t(out[:, 0]), _t(full[:, -1]), rtol=1e-2,
                               atol=1e-3)
    _, ref_st = ref_ssm.mlstm_prefill(ref_p, x[:, :32], n_heads=2, chunk=8)
    want, want_new = ref_ssm.mlstm_step(ref_p, x[:, 32:], ref_st, n_heads=2)
    close(out, want, 1e-2, 1e-3)
    for a, b in zip(new, want_new):
        close(a, b, 1e-3, 1e-4)


def test_mamba_prefill_then_step_continues():
    ref_p = ref_ssm.init_mamba(KEY, 16, d_state=8)
    p = like_params(ref_p)
    x = jax.random.normal(jax.random.PRNGKey(4), (1, 41, 16))
    xt = to_port(x)
    full, _ = ssm.mamba_prefill(p, xt, d_state=8)
    _, st = ssm.mamba_prefill(p, xt[:, :40], d_state=8)
    out, new = ssm.mamba_step(p, xt[:, 40:], st, d_state=8)
    np.testing.assert_allclose(_t(out[:, 0]), _t(full[:, -1]), rtol=1e-2,
                               atol=1e-3)
    want_full, _ = ref_ssm.mamba_prefill(ref_p, x, d_state=8)
    close(full, want_full, 1e-2, 1e-3)
    _, ref_st = ref_ssm.mamba_prefill(ref_p, x[:, :40], d_state=8)
    for a, b in zip(st, ref_st):
        close(a, b, 1e-4, 1e-6)
    want, want_new = ref_ssm.mamba_step(ref_p, x[:, 40:], ref_st, d_state=8)
    close(out, want, 1e-2, 1e-3)
    for a, b in zip(new, want_new):
        close(a, b, 1e-4, 1e-6)


def test_slstm_prefill_then_step_continues():
    ref_p = ref_ssm.init_slstm(KEY, 16, 1)
    p = like_params(ref_p)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 25, 16))
    xt = to_port(x)
    full, _ = ssm.slstm_prefill(p, xt)
    _, st = ssm.slstm_prefill(p, xt[:, :24])
    out, new = ssm.slstm_step(p, xt[:, 24:], st)
    np.testing.assert_allclose(_t(out[:, 0]), _t(full[:, -1]), rtol=1e-3,
                               atol=1e-4)
    _, ref_st = ref_ssm.slstm_prefill(ref_p, x[:, :24])
    want, want_new = ref_ssm.slstm_step(ref_p, x[:, 24:], ref_st)
    close(out, want, 1e-3, 1e-4)
    for a, b in zip(new, want_new):
        close(a, b, 1e-4, 1e-6)


@pytest.mark.parametrize("chunk", [8, 256])
def test_mamba_scan_matches_reference(chunk):
    """The chunked selective scan on the same float32 inputs, 64 positions
    in 8 chunks (the state crossing chunk boundaries) and in one: the
    Hillis-Steele passes against XLA's ``associative_scan``, at dt*a down
    to about -11 a step (an ``exp(cumsum)`` form would underflow)."""
    rng = np.random.default_rng(chunk)
    b, s, di, n = 2, 64, 12, 8
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) * 2)).astype(
        np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    d_skip = rng.standard_normal(di).astype(np.float32)
    assert (dt[..., None] * a).min() < -10
    want_y, want_st = ref_ssm._mamba_ssm_scan(
        *(jnp.asarray(v) for v in (u, dt, a, bi, ci, d_skip)), chunk=chunk)
    got_y, got_st = ssm._mamba_ssm_scan(
        *(torch.as_tensor(v) for v in (u, dt, a, bi, ci, d_skip)),
        chunk=chunk)
    close(got_y, want_y, 1e-5, 1e-5)
    close(got_st, want_st, 1e-5, 1e-5)


def test_recurrent_init_states_match_reference():
    for got, want in (
            (ssm.mamba_init_state(3, 8, d_state=4, device="cpu"),
             ref_ssm.mamba_init_state(3, 8, d_state=4)),
            (ssm.mlstm_init_state(3, 8, 2, device="cpu"),
             ref_ssm.mlstm_init_state(3, 8, 2)),
            (ssm.slstm_init_state(3, 8, device="cpu"),
             ref_ssm.slstm_init_state(3, 8))):
        same_tree(got, want, 0, 0)
    assert ssm.mamba_init_state(3, 8, d_state=4, device="cpu")[1].shape == (
        3, 3, 16)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_state_shapes_match_reference(name):
    """The stacked decode state: the reference's leaves, shapes and dtypes
    (float32 recurrent states independent of ``max_seq``)."""
    cfg = port_base.get_arch(name, smoke=True)
    ref_cfg = ref_base.get_arch(name, smoke=True)
    for max_seq in (8, 24):
        got = api.init_decode_state(cfg, 3, max_seq, device="cpu")
        want = ref_api.init_decode_state(ref_cfg, 3, max_seq)
        assert sorted(got) == sorted(want)
        same_tree(got, want, 0, 0, name)
        assert got["cache_len"].dtype == torch.int32
    leaves = tree_leaves(got)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)   # no alias


# ---------------------------------------------------------------------------
# Encoder-decoder and cross-attention
# ---------------------------------------------------------------------------

def test_cross_attention_matches_reference():
    c = case(ENCDEC)
    cfg = c.cfg
    ref_p = jax.tree_util.tree_map(lambda a: a[0],
                                   c.ref_params["dec_blocks"]["cross_attn"])
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, 5, cfg.d_model))).astype(
        jnp.bfloat16)
    mem = jnp.asarray(rng.standard_normal((B, 11, cfg.d_model))).astype(
        jnp.bfloat16)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              d_head=cfg.head_dim)
    want = ref_attn.cross_attention(ref_p, x, mem, **kw)
    got = port_attn.cross_attention(like_params(ref_p), to_port(x),
                                    to_port(mem), **kw)
    assert got.dtype == torch.bfloat16
    close(got, want, 0.02, 0.02)


def test_encode_matches_reference():
    c = case(ENCDEC)
    want, got = c.memories()
    assert got.dtype == torch.bfloat16
    close(got, want, 0.02, 0.05)


def test_encdec_forward_and_prefill_match_reference():
    c = case(ENCDEC)
    toks = jnp.asarray(c.tokens)
    want, want_aux = ref_encdec.forward(c.ref_cfg, c.ref_params, toks,
                                        c.ref_frames(), remat="none")
    got, aux = encdec.forward(c.cfg, c.params, torch.as_tensor(c.tokens),
                              c.port_frames())
    assert got.dtype == torch.float32
    close(got, want, what="train")
    assert float(aux) == float(want_aux) == 0.0
    want, want_st = ref_api.prefill_fn(c.ref_cfg)(
        c.ref_params, {"tokens": toks, "frontend": c.ref_frames()})
    got, st = api.prefill_fn(c.cfg)(
        c.params, {"tokens": torch.as_tensor(c.tokens),
                   "frontend": c.port_frames()})
    close(got, want, what="prefill")
    assert sorted(st) == ["memory", "self"]
    same_tree(st, want_st, what="prefill state")


# ---------------------------------------------------------------------------
# The stack and the encoder-decoder on every new family's smoke config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STACKED)
def test_forward_train_matches_reference(name):
    """Logits (the op-by-op reference's are its prefill's, the same
    arithmetic) and the routers' summed aux loss (0 without an MoE)."""
    c = case(name)
    got, aux = stack.forward(c.cfg, c.params, torch.as_tensor(c.tokens),
                             mode="train")
    compiled, want_aux = ref_stack.forward(
        c.ref_cfg, c.ref_params, jnp.asarray(c.tokens), mode="train",
        remat="none")
    assert got.dtype == torch.float32 and tuple(got.shape) == compiled.shape
    close(got, c.ref_prefill[0], what=name)
    close(got, compiled, REF_RTOL, REF_ATOL, f"{name} compiled")
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3,
                               atol=1e-5)
    assert (float(aux) > 0) == (c.cfg.moe is not None)


@pytest.mark.parametrize("name", STACKED)
def test_prefill_matches_reference(name):
    """Logits and every exported cache and recurrent state, stacked
    (reps, ...) per superblock position."""
    c = case(name)
    got, caches = api.prefill_fn(c.cfg)(
        c.params, {"tokens": torch.as_tensor(c.tokens)})
    want, want_caches = c.ref_prefill
    close(got, want, what=name)
    same_tree(caches, want_caches, what=f"{name} prefill caches")
    compiled, _ = ref_api.prefill_fn(c.ref_cfg)(
        c.ref_params, {"tokens": jnp.asarray(c.tokens)})
    close(got, compiled, REF_RTOL, REF_ATOL, f"{name} compiled")


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_match_reference(name):
    c = case(name)
    steps, ref_state, state = c.decode_both(N_DECODE)
    for t, (a, b) in enumerate(steps):
        assert tuple(b.shape) == a.shape == (B, 1, c.cfg.padded_vocab)
        close(b, a, what=f"{name} step {t}")
    assert int(state["cache_len"]) == int(ref_state["cache_len"]) == N_DECODE
    same_tree(state, ref_state, what=f"{name} state")


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_forward(name, monkeypatch):
    """The port's step-by-step decode against its parallel forward at the
    last of 8 tokens, within the reference's bound, with the dense MoE
    dispatch (the reference's ``test_prefill_decode_consistency``;
    capacity dropping depends on the batch by design).  The encoder-
    decoder decodes against ``encode(frames)``."""
    monkeypatch.setattr(moe, "FORCE_IMPL", "dense")
    c = case(name)
    cfg, params = c.cfg, c.params
    toks = torch.as_tensor(c.tokens[:1, :8])
    state = api.init_decode_state(cfg, 1, 16, device="cpu")
    if c.encdec:
        frames = c.port_frames()[:1]
        full, _ = encdec.forward(cfg, params, toks, frames)
        state["memory"] = encdec.encode(cfg, params, frames)
    else:
        full, _ = stack.forward(cfg, params, toks, mode="train")
    dec = api.decode_fn(cfg)
    for t in range(8):
        logits, state = dec(params, state, toks[:, t:t + 1])
    np.testing.assert_allclose(_t(logits[0, -1]), _t(full[0, -1]),
                               rtol=REF_RTOL, atol=REF_ATOL)


@pytest.mark.parametrize("name", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_recurrent_decode_writes_state_in_place(name):
    """A recurrent layer's new state lands in the stacked state's own
    tensors, which the returned state shares."""
    c = case(name)
    state = api.init_decode_state(c.cfg, B, 8, device="cpu")
    before = [t for t in tree_leaves(state["layers"])]
    _, new = api.decode_fn(c.cfg)(c.params, state,
                                  torch.as_tensor(c.tokens[:, :1]))
    after = tree_leaves(new["layers"])
    assert all(a is b for a, b in zip(before, after))
    mixers = [m for m, _ in stack.block_structure(c.cfg)]
    for mixer, layer in zip(mixers, new["layers"]):
        if mixer != "a":
            assert all(bool(t.abs().sum() > 0) for t in layer), mixer


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

def _models(name: str):
    c = case(name)
    return c.ref_cfg, c.ref_params, c.cfg, c.params


@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("name", ENGINE)
def test_engine_matches_reference(name, asyn):
    """2 fixed slots, 6 requests in two waves (tests/test_torch_serve.py's
    drive) against the reference's drive in the same mode: slots refill,
    empty and freed rows decode beside live ones, and the shared clock
    passes ``max_seq``.  Under the dropping MoE dispatch those rows
    compete for expert capacity, and the two modes feed an empty row
    other tokens (sync 0, async its last sampled one), as the reference
    does."""
    models = _models(name)
    ref = serve.ref_run(models, asyn=asyn, batch_slots=2)
    got = serve.port_run(models, asyn, batch_slots=2)
    serve.same_tokens(got, ref, models[2].vocab)
    assert got.clock == ref.clock > serve.MAX_SEQ
    assert got.events == ref.events


def _traced_drive(eng, request, vocab, asyn):
    """An elastic drive that records, per decode tick, the tokens fed to
    every row (live, empty and freed) and the logits of every row."""
    feeds, rows = [], []
    decode = eng._decode

    def traced(params, state, last):
        logits, state = decode(params, state, last)
        feeds.append(np.asarray(last).ravel().tolist())
        rows.append(np.asarray(logits[:, -1], np.float32))
        return logits, state

    eng._decode = traced    # the ticks only: each prefill has its own step
    tokens, caps = serve._drive(eng, serve._requests(request, vocab), asyn)
    return tokens, caps, feeds, rows


@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
def test_engine_moe_elastic_matches_reference(asyn):
    """An elastic pool (2 -> 8 -> 2) on the MoE against the reference's
    elastic engine (a fixed pool's tokens need not be equal: the batch
    shape sets the expert capacity).  Under the dropping dispatch every
    row competes for capacity, so the tokens fed to the empty and freed
    rows are held too: tick by tick, every row's fed token equals the
    reference's, up to the first tick where one differs; there, each
    differing token was a near tie of the reference's logits of its row
    one tick before.  Async feeds an empty row its last sampled token, so
    a near tie in a row no request reads can move the live rows' experts;
    the live rows' fed tokens are the requests' tokens, so those are
    compared up to that tick."""
    models = _models("deepseek-moe-16b")
    ref_cfg, ref_params, cfg, params = models
    kw = dict(batch_slots=2, max_slots=8, min_slots=2)
    want, want_caps, want_feeds, want_rows = _traced_drive(
        serve.ref_engine.Engine(ref_cfg, ref_params, max_seq=serve.MAX_SEQ,
                                **kw), serve.ref_engine.Request, cfg.vocab,
        asyn)
    got, caps, feeds, _ = _traced_drive(
        engine.Engine(cfg, params, max_seq=serve.MAX_SEQ, **kw),
        engine.Request, cfg.vocab, asyn)
    assert max(caps) == 8 and caps == want_caps
    split = next((i for i, (a, b) in enumerate(zip(want_feeds, feeds))
                  if a != b), None)
    if split is None:
        assert got == want
        return
    assert split > 0
    for row, (a, b) in enumerate(zip(want_feeds[split], feeds[split])):
        if a != b:
            logits = want_rows[split - 1][row, :cfg.vocab]
            assert int(np.argmax(logits)) == a
            assert float(logits[a] - logits[b]) <= LOGIT_ATOL, (split, row)


def test_engine_moe_two_shards_match_one():
    models = _models("deepseek-moe-16b")
    n = len(serve.MAX_NEW)
    got = serve.port_run(models, False, n, batch_slots=4,
                         mesh=make_stream_mesh(2, device="cpu"))
    one = serve.port_run(models, False, n, batch_slots=4)
    assert got.tokens == one.tokens and got.clock == one.clock


def test_engine_state_flattening_follows_the_keys():
    """The encoder-decoder's state flattens by its own keys, and its slot
    axes are inferred on the ``meta`` device: the clock -1, the caches'
    1 (n_layers, batch, ...), the memory's 0."""
    cfg = port_base.get_arch(ENCDEC, smoke=True)
    state = api.init_decode_state(cfg, 2, 8, device="cpu")
    flat = engine._flat(state)
    assert flat == (state["cache_len"], state["memory"], state["self"])
    assert engine._unflat(flat, state) == state
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    eng = engine.Engine(cfg, params, batch_slots=2, max_seq=8)
    assert eng._cache_axes == (-1, 0, (1, 1))


def test_launcher_serves_every_family():
    for name in FAMILIES:
        serve.port_launch.main(["--arch", name, "--smoke", "--requests", "2",
                                "--slots", "2", "--prompt-len", "3",
                                "--max-new", "2", "--device", "cpu"])
