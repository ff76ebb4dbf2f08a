"""The port's LM loss and gradients against the reference's on the CPU
for llama4-scout-17b-a16e (MoE, top-1 with a shared expert) and the
hybrid jamba-1.5-large-398b (Mamba and attention mixers, an MoE every
other layer): Mamba's checkpointed chunk scan, the router's backward, and
each MoE dispatch under a gradient.

The routing is pinned to the reference's, as in
``test_torch_lm_train_moe.py``.  Tolerances (``_torch_lm_train_cases``):
the loss within 1e-4 relative, every gradient leaf within 2e-2 in
relative L2 error; the remat modes of the port bit-equal to each other.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_lm_train_cases import Case, check_moe_case, check_remat_bit_equal
from repro_torch.models import moe
from repro_torch.utils.tree import tree_leaves

NAMES = ["jamba-1.5-large-398b", "llama4-scout-17b-a16e"]
_CASES: dict = {}


def case(name: str) -> Case:
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    check_moe_case(case(name), name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_modes_bit_equal(name):
    check_remat_bit_equal(case(name))


def test_every_dispatch_trains(monkeypatch):
    """The dense and grouped dispatches take finite gradients too; with
    the capacity to spare at top-1, the grouped dispatch's loss is the
    dropping one's."""
    c = case("llama4-scout-17b-a16e")
    losses = {}
    for impl in ("dropping", "grouped", "dense"):
        monkeypatch.setattr(moe, "FORCE_IMPL", impl)
        loss, grads, _ = c.value_and_grad("none")
        assert all(bool(torch.isfinite(g.float()).all())
                   for g in tree_leaves(grads))
        losses[impl] = float(loss)
    assert np.isfinite(list(losses.values())).all()
    assert losses["grouped"] == losses["dropping"]
