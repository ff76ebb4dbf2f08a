"""The port's LM loss and gradients against the reference's on the CPU
for the MoE smoke config deepseek-moe-16b (llama4-scout-17b-a16e and the
hybrid jamba-1.5-large-398b are in ``test_torch_lm_train_hybrid.py``):
the router's and the ``dropping`` dispatch's backward, the aux term
(``AUX_LOSS_COEF``), and the remat policies through re-routed
superblocks.

The port's routing is pinned to the reference's (recorded from its
op-by-op forward; a row is taken over only where the port's own experts
differ), so a near tie cannot move the comparison.  Tolerances
(``_torch_lm_train_cases``): the loss within 1e-4 relative, every
gradient leaf within 2e-2 in relative L2 error; the remat modes of the
port bit-equal to each other.
"""
from __future__ import annotations

import numpy as np

from _torch_lm_train_cases import Case, check_moe_case, check_remat_bit_equal
from repro_torch.models import stack

NAME = "deepseek-moe-16b"
_CASES: dict = {}


def case() -> Case:
    if NAME not in _CASES:
        _CASES[NAME] = Case(NAME)
    return _CASES[NAME]


def test_loss_and_gradients_match_reference():
    check_moe_case(case(), NAME)


def test_aux_loss_enters_the_loss(monkeypatch):
    """The loss is the cross-entropy + AUX_LOSS_COEF x the routers' summed
    aux loss: with the coefficient at 0 the loss drops by exactly that."""
    c = case()
    loss, _, _ = c.value_and_grad("none")
    _, _, aux = stack.forward_hidden(c.cfg, c.params, c.batch["tokens"],
                                     remat="none")
    monkeypatch.setattr(stack, "AUX_LOSS_COEF", 0.0)
    ce, _, _ = c.value_and_grad("none")
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss) - float(ce), 0.01 * float(aux),
                               rtol=1e-4)


def test_remat_modes_bit_equal():
    """The checkpointed superblocks re-route in the backward and meet the
    same experts."""
    check_remat_bit_equal(case())
