"""Gradient compression for bandwidth-limited links, with error feedback.

Two schemes; the residual of the compression is carried into the next
step (which is what keeps convergence), in the optimizer state under
``"ef"``:

  * sign1bit — 1-bit sign + per-tensor L1 scale (signSGD-EF / 1-bit Adam
    style): 32x smaller payload.
  * topk     — keep the largest k-fraction entries (magnitude), zero the
    rest.

They run as the optimizer's ``grad_transform`` hook, before clipping and
the update.  The port runs one process, so nothing crosses a link here:
the transform keeps the training arithmetic the reference's, and
``compressed_bytes`` gives the payload a sync would carry.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _sign_compress(g: torch.Tensor) -> torch.Tensor:
    return torch.sign(g) * torch.mean(torch.abs(g))


def _topk_compress(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return g * (torch.abs(g) >= thresh)


def make_transform(scheme: str = "sign1bit", topk_frac: float = 0.01):
    """Returns grad_transform(grads, opt_state) -> (grads', opt_state'),
    or None for ``"none"``."""
    if scheme == "none":
        return None
    if scheme == "sign1bit":
        comp = _sign_compress
    elif scheme == "topk":
        comp = functools.partial(_topk_compress, frac=topk_frac)
    else:
        raise ValueError(scheme)

    def transform(grads, state):
        ef = state.get("ef")
        if ef is None:
            ef = tree_map(torch.zeros_like, grads)
        corrected = tree_map(torch.add, grads, ef)
        compressed = tree_map(comp, corrected)
        state = dict(state)
        state["ef"] = tree_map(torch.sub, corrected, compressed)
        return compressed, state

    return transform


def compressed_bytes(tree, scheme: str = "sign1bit",
                     topk_frac: float = 0.01) -> int:
    """Payload size of one sync of ``tree`` under the scheme."""
    leaves = tree_leaves(tree)
    n = int(sum(t.numel() for t in leaves))
    if scheme == "sign1bit":
        return n // 8 + 4 * len(leaves)
    if scheme == "topk":
        return int(n * topk_frac) * 8  # value + index
    return n * 4
