"""Shared inputs and checks of the port's LM training parity tests
(``tests/test_torch_lm_train_*.py``): a smoke config's params in both
packages, a batch from the data pipeline, the reference's loss and
gradients run op by op (``jax.disable_jit``), the port's on the CPU with
the MoE routing pinned to the reference's, and the per-leaf comparison.

Tolerances: the loss within ``LOSS_RTOL`` of the reference's op-by-op
loss, and every gradient leaf within ``GRAD_REL_L2`` of the reference's
in relative L2 error, ``|g - g_ref| / |g_ref|`` (bf16 leaves take bf16
gradients, whose tiny entries no elementwise tolerance can hold; a
leaf's error is measured against its own norm).  The op-by-op reference
rounds every bf16 intermediate as the port does; the compiled one fuses
and drops some of those roundings, and its gradients differ from its own
op-by-op ones by ~1.5e-2 in relative L2 on the dense smoke configs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as ref_base
from repro.data import lm_data as ref_lm_data
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro_torch.configs import base as port_base
from repro_torch.data import lm_data
from repro_torch.models import api, moe
from repro_torch.train import loop
from repro_torch.utils.tree import tree_leaves

LOSS_RTOL = 1e-4
GRAD_REL_L2 = 2e-2
B, S = 2, 16


def port_tree(cfg, ref_params):
    return api.params_from_numpy(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), ref_params),
        device="cpu")


class Case:
    """One smoke config in both packages (optionally in another quant
    mode), its params and one batch of ``lm_data`` (with frontend
    embeddings for the VLM and encoder-decoder families)."""

    def __init__(self, name: str, quant_mode: str | None = None):
        self.ref_cfg = ref_base.get_arch(name, smoke=True)
        self.cfg = port_base.get_arch(name, smoke=True)
        if quant_mode:
            self.ref_cfg = dataclasses.replace(self.ref_cfg,
                                               quant_mode=quant_mode)
            self.cfg = dataclasses.replace(self.cfg, quant_mode=quant_mode)
        self.ref_params = ref_api.init_params(self.ref_cfg,
                                              jax.random.PRNGKey(0))
        self.params = port_tree(self.cfg, self.ref_params)
        cfg = self.cfg
        kw = dict(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=1,
                  frontend_tokens=(cfg.n_frontend_tokens
                                   or (S if cfg.family == "encdec" else 0)),
                  frontend_dim=cfg.d_model)
        self.ref_batch = jax.tree_util.tree_map(
            jnp.asarray, ref_lm_data.batch_at(ref_lm_data.DataConfig(**kw),
                                              0))
        self.batch = lm_data.to_device(
            lm_data.batch_at(lm_data.DataConfig(**kw), 0), "cpu")
        self.routing: list = []

    def ref_value_and_grad(self, remat: str = "none"):
        """The reference's loss and gradients op by op; its routing, from
        an op-by-op forward, kept in ``self.routing``."""
        loss_fn = ref_api.loss_fn(self.ref_cfg, remat=remat)
        with jax.disable_jit():
            if self.cfg.moe is not None:
                self.routing = []
                with _recorded(self.routing):
                    loss_fn(self.ref_params, self.ref_batch)
            return jax.value_and_grad(loss_fn)(self.ref_params,
                                               self.ref_batch)

    def value_and_grad(self, remat: str = "none"):
        """The port's loss and gradients, the routing pinned to
        ``self.routing`` -> (loss, grads, rows taken over)."""
        fn = api.loss_fn(self.cfg, remat)
        if self.cfg.moe is None:
            loss, grads = loop.value_and_grad(fn, self.params, self.batch)
            return loss, grads, 0
        pin = _Pin(self.routing)
        with pin:
            loss, grads = loop.value_and_grad(fn, self.params, self.batch)
        return loss, grads, pin.held


@contextlib.contextmanager
def _recorded(calls: list):
    own = ref_moe._router

    def router(p, x, top_k):
        out = own(p, x, top_k)
        calls.append(np.asarray(out[1]))
        return out
    ref_moe._router = router
    try:
        yield
    finally:
        ref_moe._router = own


class _Pin:
    """The port's ``moe.route`` held to recorded routing: the i-th router
    met (by its weight's storage, so a checkpointed recomputation meets
    its own entry again) takes the i-th recorded experts wherever its own
    differ, with gates re-normalised from its own probabilities and the
    aux loss counted on the recorded experts; ``held`` counts the rows
    taken over."""

    def __init__(self, routing):
        self.routing = routing
        self.slots: dict = {}
        self.held = 0

    def __enter__(self):
        self.own = moe.route

        def route(p, x, top_k):
            vals, idx, aux = self.own(p, x, top_k)
            key = p["router"].data_ptr()
            if key not in self.slots:
                self.slots[key] = len(self.slots)
            rec = torch.from_numpy(np.array(self.routing[self.slots[key]])
                                   ).to(idx)
            if torch.equal(idx, rec):
                return vals, idx, aux
            self.held += int((idx != rec).any(-1).sum())
            n = x.shape[0] * x.shape[1]
            probs = torch.softmax(x.reshape(n, -1).to(torch.float32)
                                  @ p["router"], dim=-1)
            vals = probs.gather(1, rec)
            vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
            e = probs.shape[-1]
            frac = torch.nn.functional.one_hot(rec, e).to(
                torch.float32).sum(1).mean(0) / top_k
            return vals, rec, e * torch.sum(frac * probs.mean(0))
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.own


def rel_l2(got: torch.Tensor, want) -> float:
    g = got.detach().to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def check_grads(grads, ref_grads, bound=GRAD_REL_L2, what=""):
    """Every leaf: the reference's structure, shape and dtype, finite,
    and within ``bound`` in relative L2 -> the worst error."""
    g = tree_leaves(grads)
    w = jax.tree_util.tree_leaves(ref_grads)
    assert len(g) == len(w), what
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape, (what, i)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (what, i)
        assert bool(torch.isfinite(a.float()).all()), (what, i)
        err = rel_l2(a, b)
        assert err <= bound, f"{what} leaf {i} {tuple(a.shape)}: {err}"
        worst = max(worst, err)
    return worst


def check_loss(loss, ref_loss, what=""):
    assert loss.dtype == torch.float32 and loss.shape == (), what
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL,
                               err_msg=what)


def check_remat_bit_equal(c: Case):
    """none / block / dots: the same loss and gradients, bit for bit."""
    runs = {m: c.value_and_grad(m) for m in ("none", "block", "dots")}
    base_loss, base_g, _ = runs["none"]
    for mode in ("block", "dots"):
        loss, grads, _ = runs[mode]
        assert torch.equal(loss, base_loss), mode
        for a, b in zip(tree_leaves(grads), tree_leaves(base_g)):
            assert torch.equal(a, b), mode


def check_moe_case(c: Case, name: str):
    """Loss and every gradient leaf on the reference's routing (a row
    taken over only at a near tie: at most 2 a layer); the routers'
    gradients non-zero."""
    from repro_torch.models import stack
    want, want_g = c.ref_value_and_grad("none")
    struct = stack.block_structure(c.cfg)
    n_moe = sum(1 for _, f in struct if f == "moe") * stack.n_repeats(c.cfg)
    assert len(c.routing) == n_moe > 0
    loss, grads, held = c.value_and_grad("none")
    check_loss(loss, want, name)
    check_grads(grads, want_g, what=name)
    assert held <= 2 * n_moe, held
    router = [grads["blocks"][pos]["moe"]["router"]
              for pos, (_, ffn) in enumerate(struct) if ffn == "moe"]
    assert router and all(float(g.abs().sum()) > 0 for g in router)
