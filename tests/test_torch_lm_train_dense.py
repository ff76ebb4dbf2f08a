"""The port's LM loss and gradients (``api.loss_fn``) against the
reference's on the CPU: the dense smoke configs (qwen3-0.6b, yi-9b,
internlm2-1.8b, deepseek-coder-33b), Qwen3 in the ``ternary`` quant mode,
and the remat policies.

Every case carries the reference's params across
(``api.params_from_numpy``) and trains on one ``lm_data`` batch; the
reference runs op by op (``jax.disable_jit``).  Tolerances
(``_torch_lm_train_cases``): the loss within ``LOSS_RTOL`` (1e-4)
relative, every gradient leaf within ``GRAD_REL_L2`` (2e-2) in relative
L2 error; the remat modes of the port bit-equal to each other.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm_train_cases import (
    Case,
    check_grads,
    check_loss,
    check_remat_bit_equal,
)
from repro_torch.models import api
from repro_torch.models import attention as port_attn
from repro_torch.train import loop
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

DENSE = ["qwen3-0.6b", "yi-9b", "internlm2-1.8b", "deepseek-coder-33b"]
_CASES: dict = {}


def case(name: str, quant_mode: str | None = None) -> Case:
    key = (name, quant_mode)
    if key not in _CASES:
        _CASES[key] = Case(name, quant_mode)
    return _CASES[key]


def _finite_nonzero(loss, grads):
    """The reference's ``test_arch_smoke_train_step`` contract: a finite
    loss and a finite, non-zero gradient norm."""
    assert torch.isfinite(loss)
    gnorm = sum(float(g.float().abs().sum()) for g in tree_leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_gradients_match_reference(name):
    c = case(name)
    want, want_g = c.ref_value_and_grad("none")
    loss, grads, _ = c.value_and_grad("none")
    check_loss(loss, want, name)
    check_grads(grads, want_g, what=name)
    _finite_nonzero(loss, grads)


def test_ternary_loss_and_gradients_match_reference():
    """The ``ternary`` quant mode through ``quant.ternarize_weight``'s
    straight-through gradient (the reference's
    ``test_ternary_quant_mode_runs``, held to its values)."""
    c = case("qwen3-0.6b", "ternary")
    want, want_g = c.ref_value_and_grad("none")
    loss, grads, _ = c.value_and_grad("none")
    check_loss(loss, want, "ternary")
    check_grads(grads, want_g, what="ternary")
    _finite_nonzero(loss, grads)
    # the ternary loss differs from the fp one: the mode is in effect
    assert float(loss) != float(case("qwen3-0.6b").value_and_grad()[0])


@pytest.mark.parametrize("flash", [False, True], ids=["block-sdpa", "flash"])
def test_remat_modes_bit_equal(flash, monkeypatch):
    """none / block / dots: the same loss and gradients, bit for bit; with
    ``QUERY_CHUNK`` / ``KV_CHUNK`` patched to 4 the attention takes the
    flash path with 4 query chunks, each checkpointed."""
    if flash:
        monkeypatch.setattr(port_attn, "QUERY_CHUNK", 4)
        monkeypatch.setattr(port_attn, "KV_CHUNK", 4)
    check_remat_bit_equal(case("qwen3-0.6b"))


def test_remat_block_matches_reference_block():
    c = case("qwen3-0.6b")
    want, want_g = c.ref_value_and_grad("block")
    loss, grads, _ = c.value_and_grad("block")
    check_loss(loss, want, "block")
    check_grads(grads, want_g, what="block")


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_modes_recompute_what_they_say():
    """In the backward pass: ``none`` recomputes only the chunked loss's
    projection (one output norm), ``block`` also the blocks' products and
    norms, ``dots`` the blocks' norms (rsqrt) but no non-batched product
    (their outputs are kept)."""
    c = case("qwen3-0.6b")
    counts = {}
    for mode in ("none", "block", "dots"):
        fn = api.loss_fn(c.cfg, mode)
        leaves, structure = tree_flatten(c.params)
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        loss = fn(tree_unflatten(structure, leaves), c.batch)
        with _CountOps() as ops:
            torch.autograd.grad(loss, leaves, allow_unused=True)
        counts[mode] = ops.ops
    mm, rsqrt = torch.ops.aten.mm.default, torch.ops.aten.rsqrt.default
    assert counts["none"][rsqrt] == 1
    # norm1, norm2 (and q_norm, k_norm) a layer
    n_norms = (4 if c.cfg.qk_norm else 2) * c.cfg.n_layers
    assert counts["block"][rsqrt] == counts["dots"][rsqrt] == 1 + n_norms
    assert counts["block"][mm] > counts["none"][mm]
    assert counts["dots"][mm] == counts["none"][mm]


def test_unknown_remat_mode_raises():
    c = case("qwen3-0.6b")
    with pytest.raises(ValueError, match="bogus"):
        loop.value_and_grad(api.loss_fn(c.cfg, "bogus"), c.params, c.batch)
