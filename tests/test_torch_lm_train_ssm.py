"""The port's LM loss and gradients against the reference's on the CPU
for the recurrent, vision-language and encoder-decoder smoke configs
(xlstm-350m, phi-3-vision-4.2b, seamless-m4t-medium), Phi-3-vision in
the ``ternary`` quant mode, and the remat policies through the mLSTM
chunk step, the encoder-decoder's decoder blocks and a frontend.

The VLM's loss covers its text positions only; the encoder-decoder's has
no aux term.  Tolerances (``_torch_lm_train_cases``): the loss within
1e-4 relative, every gradient leaf within 2e-2 in relative L2 error; the
remat modes of the port bit-equal to each other.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_lm_train_cases import (
    Case,
    check_grads,
    check_loss,
    check_remat_bit_equal,
)
from repro_torch.models import layers, stack
from repro_torch.utils.tree import tree_leaves

NAMES = ["xlstm-350m", "phi-3-vision-4.2b", "seamless-m4t-medium"]
_CASES: dict = {}


def case(name: str, quant_mode: str | None = None) -> Case:
    key = (name, quant_mode)
    if key not in _CASES:
        _CASES[key] = Case(name, quant_mode)
    return _CASES[key]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    c = case(name)
    want, want_g = c.ref_value_and_grad("none")
    loss, grads, _ = c.value_and_grad("none")
    check_loss(loss, want, name)
    check_grads(grads, want_g, what=name)
    gnorm = sum(float(g.float().abs().sum()) for g in tree_leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0


def test_ternary_vlm_matches_reference():
    c = case("phi-3-vision-4.2b", "ternary")
    want, want_g = c.ref_value_and_grad("none")
    loss, grads, _ = c.value_and_grad("none")
    check_loss(loss, want, "ternary vlm")
    check_grads(grads, want_g, what="ternary vlm")


@pytest.mark.parametrize("name", NAMES)
def test_remat_modes_bit_equal(name):
    check_remat_bit_equal(case(name))


def test_vlm_loss_covers_text_positions_only():
    """The frontend's positions carry no label: the loss equals the
    cross-entropy of the logits at the text positions."""
    c = case("phi-3-vision-4.2b")
    loss, _, _ = c.value_and_grad("none")
    with torch.no_grad():
        logits, aux = stack.forward(c.cfg, c.params, c.batch["tokens"],
                                    frontend=c.batch["frontend"])
    text = logits[:, -c.batch["tokens"].shape[1]:]
    ce = torch.nn.functional.cross_entropy(
        text.reshape(-1, text.shape[-1]), c.batch["labels"].reshape(-1))
    np.testing.assert_allclose(float(loss), float(ce), rtol=1e-5)
    assert float(aux) == 0.0


def test_mlstm_chunks_checkpointed_bit_equal(monkeypatch):
    """The mLSTM's chunk steps under ``layers.checkpoint`` (4 chunks of
    4): the gradients equal the uncheckpointed run's bit for bit, and the
    one-chunk run's within float32 noise of the chunked algebra."""
    from repro_torch.models import ssm
    c = case("xlstm-350m")
    p = stack.index_tree(c.params["blocks"][0]["mlstm"], 0)
    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    x = torch.randn(2, 16, c.cfg.d_model, generator=torch.Generator(
        ).manual_seed(0)).to(torch.bfloat16).requires_grad_(True)

    def grads(chunk):
        out, _ = ssm.mlstm_prefill(p, x, n_heads=c.cfg.n_heads,
                                   expand=c.cfg.ssm_expand, chunk=chunk)
        return torch.autograd.grad(out.float().square().sum(),
                                   [x, *p.values()], allow_unused=True,
                                   materialize_grads=True)

    ck, whole = grads(4), grads(16)
    monkeypatch.setattr(layers, "checkpoint", lambda fn, *a: fn(*a))
    plain = grads(4)
    for a, b, w in zip(ck, plain, whole):
        assert torch.equal(a, b)
        np.testing.assert_allclose(
            a.float().numpy(), w.float().numpy(), rtol=0.05,
            atol=0.05 * float(w.float().abs().max()) + 1e-6)


def test_encdec_remat_wraps_decoder_blocks_only(monkeypatch):
    """``block`` checkpoints each decoder block and no encoder block, as
    the reference's ``forward_hidden`` does."""
    c = case("seamless-m4t-medium")
    calls = []
    real = layers.checkpoint

    def spy(fn, *args, **kw):
        calls.append(getattr(fn, "__qualname__", ""))
        return real(fn, *args, **kw)
    monkeypatch.setattr(layers, "checkpoint", spy)
    c.value_and_grad("block")
    blocks = [n for n in calls if n.endswith("block")]
    assert blocks == ["forward_hidden.<locals>.block"] * c.cfg.n_layers
