"""The scan helper of the LM stack: a Python loop over a leading axis.

The port of the reference's ``repro/models/scan_utils.py``.  Its
``SCAN_UNROLL`` switch serves only the JAX dry run's cost pass and has no
counterpart here: a loop in eager PyTorch is always unrolled.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def scan(f, init, xs):
    """``jax.lax.scan`` semantics: ``carry, y = f(carry, x)`` for each
    slice ``x`` of the tree ``xs`` along its leading axis (views, nothing
    copied); returns ``(carry, ys)`` with the ``y`` trees stacked along a
    new leading axis (``None`` when ``f`` returns no ``y``)."""
    n = tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)
