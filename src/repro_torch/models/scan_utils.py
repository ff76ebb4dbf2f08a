"""The scan helper of the LM stack: a Python loop over a leading axis.

The port of the reference's ``repro/models/scan_utils.py``.  Its
``SCAN_UNROLL`` switch serves only the JAX dry run's cost pass and has no
counterpart here: a loop in eager PyTorch is always unrolled.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def scan(f, init, xs):
    """``jax.lax.scan`` semantics: ``carry, y = f(carry, x)`` for each
    slice ``x`` of the tree ``xs`` along its leading axis (views, nothing
    copied); returns ``(carry, ys)`` with the ``y`` trees stacked along a
    new leading axis (``None`` when ``f`` returns no ``y``).  Each leaf is
    unbound once, so a gradient reaches a stacked leaf as one stack of
    the slices' gradients (indexing each slice apart would add a
    leaf-sized zero-filled tensor per slice)."""
    leaves, structure = tree_flatten(xs)
    slices = [a.unbind(0) for a in leaves]
    carry, ys = init, []
    for i in range(leaves[0].shape[0]):
        carry, y = f(carry, tree_unflatten(structure, [s[i] for s in slices]))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)
