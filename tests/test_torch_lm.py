"""The port's LM stack (``repro_torch.configs``, ``models.{layers,
attention,stack,api,scan_utils}``) against the reference's on the CPU.

Every ``dense`` and ``vlm`` smoke config runs with the reference's params
carried over through ``params_from_numpy``: the train-mode forward, the
prefill (logits and exported caches), 8 decode steps (logits, caches and
the clock), the flash path (``QUERY_CHUNK`` / ``KV_CHUNK`` patched in both
packages), ternary linears, replicated KV heads, a decode past
``max_seq`` (the clamped cache write of ROADMAP C.6) and decode against
forward.  Configs and parameter counts equal the reference's for every
name; the families that wait for ROADMAP A.13b raise.

Tolerance: logits within ``rtol=LOGIT_RTOL, atol=LOGIT_ATOL`` of the
reference's, bf16 caches within ``CACHE_RTOL, CACHE_ATOL`` (both tighter
than the reference's own prefill/decode bound, rtol 0.06 / atol 0.15 in
``tests/test_models.py``).  The port cannot be bit-exact: XLA's and
PyTorch's ``exp``, ``rsqrt``, ``cos`` and ``silu`` differ in the last
float32 bit, and a bf16 rounding now and then carries that on.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import api as ref_api
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import stack as ref_stack
from repro_torch.configs import base as port_base
from repro_torch.models import api, stack
from repro_torch.models import attention as port_attn
from repro_torch.models import layers
from repro_torch.models.scan_utils import scan

LOGIT_RTOL, LOGIT_ATOL = 0.02, 0.08
CACHE_RTOL, CACHE_ATOL = 0.02, 0.05
#: the reference's own decode-vs-forward bound (tests/test_models.py)
REF_RTOL, REF_ATOL = 0.06, 0.15

SERVED = [n for n in ref_base.arch_names()
          if ref_base.get_arch(n).family in ("dense", "vlm")]
B, S, MAX_SEQ, N_DECODE = 2, 16, 16, 8


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x) -> np.ndarray:
    return x.detach().to(torch.float32).numpy()


def close(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL, what=""):
    np.testing.assert_allclose(_t(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def port_params(cfg, ref_params):
    return api.params_from_numpy(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), ref_params),
        device="cpu")


class Case:
    """One smoke config: both packages' configs, the reference's params
    and the port's copy, a batch of tokens (and frontend embeddings)."""

    def __init__(self, name: str, quant_mode: str = "none"):
        self.ref_cfg = dataclasses.replace(
            ref_base.get_arch(name, smoke=True), quant_mode=quant_mode)
        self.cfg = dataclasses.replace(
            port_base.get_arch(name, smoke=True), quant_mode=quant_mode)
        self.ref_params = ref_api.init_params(self.ref_cfg,
                                              jax.random.PRNGKey(0))
        self.params = port_params(self.cfg, self.ref_params)
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(
            np.int32)
        self.frontend = None
        if self.cfg.n_frontend_tokens:
            self.frontend = rng.standard_normal(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model)).astype(
                    np.float32)

    def batches(self):
        ref = {"tokens": jnp.asarray(self.tokens)}
        port = {"tokens": torch.as_tensor(self.tokens)}
        if self.frontend is not None:
            ref["frontend"] = jnp.asarray(self.frontend).astype(jnp.bfloat16)
            port["frontend"] = torch.as_tensor(self.frontend)
        return ref, port

    def decode_both(self, n, max_seq=MAX_SEQ, kv_replication=1):
        """n decode steps of the tokens' columns (cycled) in both
        packages -> [(ref logits, port logits)], ref state, port state."""
        ref_state = ref_api.init_decode_state(
            self.ref_cfg, B, max_seq, kv_replication=kv_replication)
        state = api.init_decode_state(self.cfg, B, max_seq, kv_replication,
                                      device="cpu")
        ref_dec = jax.jit(ref_api.decode_fn(self.ref_cfg))
        dec = api.decode_fn(self.cfg)
        out = []
        for t in range(n):
            col = self.tokens[:, t % S:t % S + 1]
            a, ref_state = ref_dec(self.ref_params, ref_state,
                                   jnp.asarray(col))
            b, state = dec(self.params, state, torch.as_tensor(col))
            out.append((a, b))
        return out, ref_state, state


_CASES: dict = {}


def case(name: str, quant_mode: str = "none") -> Case:
    key = (name, quant_mode)
    if key not in _CASES:
        _CASES[key] = Case(name, quant_mode)
    return _CASES[key]


def same_state(state, ref_state):
    assert int(state["cache_len"]) == int(ref_state["cache_len"])
    assert state["cache_len"].dtype == torch.int32
    assert len(state["layers"]) == len(ref_state["layers"])
    for (k, v), (rk, rv) in zip(state["layers"], ref_state["layers"]):
        assert tuple(k.shape) == rk.shape and k.dtype == torch.bfloat16
        close(k, rk, CACHE_RTOL, CACHE_ATOL, "k cache")
        close(v, rv, CACHE_RTOL, CACHE_ATOL, "v cache")
    assert state["head"] == [] and ref_state["head"] == []


# ---------------------------------------------------------------------------
# Configs and parameter counts
# ---------------------------------------------------------------------------

def test_arch_names_match_reference():
    assert port_base.arch_names() == ref_base.arch_names()
    assert port_base.SHAPES == {
        k: port_base.ShapeConfig(**dataclasses.asdict(v))
        for k, v in ref_base.SHAPES.items()}


#: the port's config fields the reference has not (the published Jamba
#: mixer and an MoE layer that holds a share of its experts), with the
#: defaults that every registered config keeps
PORT_ONLY = {"mamba_variant": "plain"}
PORT_ONLY_MOE = {"layer_offset": 0, "held": None, "renorm_topk": True}


def _reference_fields(cfg) -> dict:
    """``asdict(cfg)`` without the port-only fields, each asserted at its
    default."""
    d = dataclasses.asdict(cfg)
    for k, v in PORT_ONLY.items():
        assert d.pop(k) == v, k
    if d["moe"] is not None:
        for k, v in PORT_ONLY_MOE.items():
            assert d["moe"].pop(k) == v, k
    return d


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ref_base.arch_names() + ["pscnn-kws"])
def test_get_arch_matches_reference(name, smoke):
    got = port_base.get_arch(name, smoke=smoke)
    want = ref_base.get_arch(name, smoke=smoke)
    if name == "pscnn-kws":
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        return
    assert _reference_fields(got) == dataclasses.asdict(want)
    assert (got.head_dim, got.padded_vocab, got.n_superblocks) == (
        want.head_dim, want.padded_vocab, want.n_superblocks)
    assert [got.layer_kind(i) for i in range(got.n_layers)] == [
        want.layer_kind(i) for i in range(want.n_layers)]
    assert all(got.supports(s) == want.supports(ref_base.SHAPES[k])
               for k, s in port_base.SHAPES.items())


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ref_base.arch_names())
def test_param_count_matches_reference(name, smoke):
    cfg = port_base.get_arch(name, smoke=smoke)
    ref_cfg = ref_base.get_arch(name, smoke=smoke)
    assert api.param_count(cfg) == ref_api.param_count(ref_cfg)
    assert api.active_param_count(cfg) == ref_api.active_param_count(
        ref_cfg)
    if not smoke:
        assert torch.zeros(1).device.type == "cpu"  # meta left no trace


def test_qwen3_full_width_param_count():
    """The published Qwen3-0.6B: ~596 M parameters, ~1.19 GB in bf16."""
    n = api.param_count(port_base.get_arch("qwen3-0.6b"))
    assert 590e6 < n < 600e6, n


# ---------------------------------------------------------------------------
# Weights across the numpy bridge, init, devices
# ---------------------------------------------------------------------------

def test_params_from_numpy_round_trip_and_dtypes():
    c = case("qwen3-0.6b")
    leaves = jax.tree_util.tree_leaves_with_path(c.ref_params)
    back = api.params_to_numpy(c.params)
    flat = jax.tree_util.tree_leaves(back)
    assert len(flat) == len(leaves)
    for (path, want), got in zip(leaves, flat):
        np.testing.assert_array_equal(got, np.asarray(
            want.astype(jnp.float32)), err_msg=str(path))
    assert c.params["embed"].dtype == torch.bfloat16
    assert c.params["out_norm"].dtype == torch.float32
    attn = c.params["blocks"][0]["attn"]
    assert attn["q_norm"].dtype == torch.float32
    assert attn["wq"].dtype == torch.bfloat16
    # ml_dtypes bf16 arrays (np.asarray of a JAX bf16 array) are read as
    # their raw words
    raw = api.params_from_numpy(
        c.cfg, jax.tree_util.tree_map(np.asarray, c.ref_params),
        device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(api.params_to_numpy(raw)),
                    flat):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", SERVED)
def test_init_params_tree_matches_reference(name):
    cfg = port_base.get_arch(name, smoke=True)
    got = api.init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    again = api.init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    want = jax.eval_shape(
        lambda k: ref_api.init_params(ref_base.get_arch(name, smoke=True),
                                      k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    g_leaves = jax.tree_util.tree_leaves(api.params_to_numpy(got))
    w_leaves = jax.tree_util.tree_leaves(want)
    assert [a.shape for a in g_leaves] == [a.shape for a in w_leaves]
    assert jax.tree_util.tree_structure(api.params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(g_leaves, jax.tree_util.tree_leaves(
            api.params_to_numpy(again))):
        np.testing.assert_array_equal(a, b)
    embed = got["embed"].float()
    assert 0.015 < float(embed.std()) < 0.025   # the reference's 0.02


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    cfg = port_base.get_arch("qwen3-0.6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_decode_state(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.params_from_numpy(cfg, {"embed": np.zeros((2, 2), np.float32)})


def test_scan_stacks_outputs_like_lax_scan():
    xs = (torch.arange(12.).reshape(4, 3), {"a": torch.ones(4, 2)})

    def f(c, x):
        return c + x[0].sum(), {"y": x[1]["a"] * c}

    carry, ys = scan(f, torch.tensor(0.), xs)
    want_c, want_y = jax.lax.scan(
        lambda c, x: (c + x[0].sum(), {"y": x[1]["a"] * c}),
        jnp.float32(0.), (jnp.arange(12.).reshape(4, 3),
                          {"a": jnp.ones((4, 2))}))
    assert float(carry) == float(want_c)
    np.testing.assert_array_equal(ys["y"].numpy(), np.asarray(want_y["y"]))
    assert scan(lambda c, x: (c, None), 0, xs)[1] is None


@pytest.mark.parametrize("seed", range(2))
def test_layers_match_reference(seed):
    """The building blocks on the same bf16 inputs: norms, RoPE (pairs
    interleaved), ternary linear and the SwiGLU MLP."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).bfloat16()
    close(layers.rmsnorm(xt, torch.as_tensor(g)),
          ref_layers.rmsnorm(xj, jnp.asarray(g)), 0, 0.02)
    close(layers.layernorm(xt, torch.as_tensor(g), torch.as_tensor(b)),
          ref_layers.layernorm(xj, jnp.asarray(g), jnp.asarray(b)), 0, 0.02)
    pos = np.arange(3, 8)[None]
    close(layers.apply_rope(xt, torch.as_tensor(pos), 1e6),
          ref_layers.apply_rope(xj, jnp.asarray(pos), 1e6), 0, 0.02)
    np.testing.assert_array_equal(
        layers.rope_freqs(16, 1e6).numpy(),
        np.asarray(ref_layers.rope_freqs(16, 1e6)))
    h = rng.standard_normal((3, 64)).astype(np.float32)
    w = {k: (rng.standard_normal(s_) / 8).astype(np.float32) for k, s_ in
         (("wi_gate", (64, 96)), ("wi_up", (64, 96)), ("wo", (96, 64)))}
    wj = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in w.items()}
    wt = {k: torch.as_tensor(v).bfloat16() for k, v in w.items()}
    hj, ht = jnp.asarray(h).astype(jnp.bfloat16), torch.as_tensor(h).bfloat16()
    for mode in ("none", "ternary"):
        close(layers.apply_linear(ht, wt["wi_up"], mode),
              ref_layers.apply_linear(hj, wj["wi_up"], mode), 0.01, 0.02)
        close(layers.apply_mlp(wt, ht, mode),
              ref_layers.apply_mlp(wj, hj, mode), 0.01, 0.03)


# ---------------------------------------------------------------------------
# Forward, prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVED)
def test_forward_train_matches_reference(name):
    c = case(name)
    ref_b, b = c.batches()
    want, want_aux = ref_stack.forward(c.ref_cfg, c.ref_params,
                                       ref_b["tokens"], ref_b.get("frontend"),
                                       mode="train", remat="none")
    got, aux = stack.forward(c.cfg, c.params, b["tokens"], b.get("frontend"),
                             mode="train")
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    close(got, want, what=name)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("name", SERVED)
def test_prefill_matches_reference(name):
    c = case(name)
    ref_b, b = c.batches()
    want, want_caches = ref_api.prefill_fn(c.ref_cfg)(c.ref_params, ref_b)
    got, caches = api.prefill_fn(c.cfg)(c.params, b)
    close(got, want, what=name)
    assert len(caches) == len(want_caches)
    for (k, v), (rk, rv) in zip(caches, want_caches):
        assert tuple(k.shape) == rk.shape
        close(k, rk, CACHE_RTOL, CACHE_ATOL, "prefill k")
        close(v, rv, CACHE_RTOL, CACHE_ATOL, "prefill v")


@pytest.mark.parametrize("name", SERVED)
def test_decode_steps_match_reference(name):
    c = case(name)
    steps, ref_state, state = c.decode_both(N_DECODE)
    for t, (a, b) in enumerate(steps):
        assert tuple(b.shape) == a.shape == (B, 1, c.cfg.padded_vocab)
        close(b, a, what=f"{name} step {t}")
    same_state(state, ref_state)
    assert int(state["cache_len"]) == N_DECODE


@pytest.mark.parametrize("name", SERVED)
def test_decode_matches_forward(name):
    """The port's own step-by-step decode against its parallel forward,
    within the reference's bound (tests/test_models.py)."""
    c = case(name)
    cfg, params = c.cfg, c.params
    toks = torch.as_tensor(c.tokens[:1, :8])
    full, _ = stack.forward(cfg, params, toks, mode="train")
    state = api.init_decode_state(cfg, 1, 16, device="cpu")
    dec = api.decode_fn(cfg)
    for t in range(8):
        logits, state = dec(params, state, toks[:, t:t + 1])
    np.testing.assert_allclose(_t(logits[0, -1]), _t(full[0, -1]),
                               rtol=REF_RTOL, atol=REF_ATOL)


@pytest.mark.parametrize("name", SERVED)
def test_flash_path_matches_reference(name, monkeypatch):
    """Chunks of 4 force ``_sdpa_flash`` in both packages (sq * sk > 16)."""
    for mod in (ref_attn, port_attn):
        monkeypatch.setattr(mod, "QUERY_CHUNK", 4)
        monkeypatch.setattr(mod, "KV_CHUNK", 4)
    c = case(name)
    ref_b, b = c.batches()
    want, _ = ref_stack.forward(c.ref_cfg, c.ref_params, ref_b["tokens"],
                                ref_b.get("frontend"), mode="train",
                                remat="none")
    got, _ = stack.forward(c.cfg, c.params, b["tokens"], b.get("frontend"),
                           mode="train")
    close(got, want, what=name)
    # and the flash path equals the port's own block path closely
    monkeypatch.setattr(port_attn, "QUERY_CHUNK", 1024)
    monkeypatch.setattr(port_attn, "KV_CHUNK", 1024)
    block, _ = stack.forward(c.cfg, c.params, b["tokens"], b.get("frontend"),
                             mode="train")
    np.testing.assert_allclose(_t(got), _t(block), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "phi-3-vision-4.2b"])
def test_ternary_quant_mode_matches_reference(name):
    c = case(name, "ternary")
    ref_b, b = c.batches()
    want, _ = ref_stack.forward(c.ref_cfg, c.ref_params, ref_b["tokens"],
                                ref_b.get("frontend"), mode="train",
                                remat="none")
    got, _ = stack.forward(c.cfg, c.params, b["tokens"], b.get("frontend"),
                           mode="train")
    close(got, want, what=name)
    steps, ref_state, state = c.decode_both(4)
    for a, b_ in steps:
        close(b_, a)
    same_state(state, ref_state)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "yi-9b"])
def test_kv_replication_matches_reference(name):
    c = case(name)
    steps, ref_state, state = c.decode_both(N_DECODE, kv_replication=2)
    for a, b in steps:
        close(b, a)
    same_state(state, ref_state)
    k = state["layers"][0][0]
    assert k.shape[3] == 2 * c.cfg.n_kv_heads
    torch.testing.assert_close(k[..., 0::2, :][:, :, :N_DECODE],
                               k[..., 1::2, :][:, :, :N_DECODE],
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "phi-3-vision-4.2b"])
def test_decode_past_max_seq_clamps_like_reference(name):
    """ROADMAP C.6: 12 steps into a 6-row cache.  The reference clamps
    the write to the last row and keeps the unclamped clock for RoPE and
    the mask; the port must do the same (torch would raise on the
    unclamped index)."""
    c = case(name)
    steps, ref_state, state = c.decode_both(12, max_seq=6)
    for a, b in steps:
        close(b, a)
    same_state(state, ref_state)
    assert int(state["cache_len"]) == 12


def test_decode_consumes_state_in_place():
    """The caches of the returned state are the input's tensors (written
    in place), and the clock is a new tensor one past the old."""
    c = case("qwen3-0.6b")
    state = api.init_decode_state(c.cfg, B, 8, device="cpu")
    k0 = state["layers"][0][0]
    clock = state["cache_len"]
    _, new = api.decode_fn(c.cfg)(c.params, state,
                                  torch.as_tensor(c.tokens[:, :1]))
    assert new["layers"][0][0] is k0
    assert int(clock) == 0 and int(new["cache_len"]) == 1
    assert bool(k0[:, :, 0].abs().sum() > 0)
    assert not bool(k0[:, :, 1:].abs().sum())


def test_lm_precision_is_restored():
    flags = torch.backends.cuda.matmul
    prev = (torch.get_float32_matmul_precision(),
            flags.allow_bf16_reduced_precision_reduction)
    c = case("qwen3-0.6b")
    stack.forward(c.cfg, c.params, torch.as_tensor(c.tokens), mode="train")
    assert (torch.get_float32_matmul_precision(),
            flags.allow_bf16_reduced_precision_reduction) == prev
