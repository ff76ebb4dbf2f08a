"""Helpers over nested containers of tensors (the port's pytrees).

A tree is a tensor (a leaf), or a dict, list or tuple of trees; ``None``
is an empty subtree.  Leaves come in the reference's order: a dict's
values by sorted key, a list's or tuple's in order, as
``jax.tree_util.tree_leaves`` gives them.
"""
from __future__ import annotations

import torch


def tree_flatten(tree) -> tuple[list, object]:
    """-> (leaves in the reference's order, the structure to rebuild)."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        if t is None:
            return ("none", None)
        leaves.append(t)
        return ("leaf", None)

    return leaves, walk(tree)


def tree_unflatten(structure, leaves) -> object:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        kind, kids = node
        if kind == "dict":
            return {k: build(v) for k, v in kids}
        if kind in ("list", "tuple"):
            seq = [build(v) for v in kids]
            return seq if kind == "list" else tuple(seq)
        if kind == "none":
            return None
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (which share its structure)."""
    leaves, structure = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for other, s in others:
        if s != structure:
            raise ValueError("trees of different structure")
    return tree_unflatten(structure, [
        fn(*args) for args in zip(leaves, *(o for o, _ in others))])


def tree_map_with_path_names(fn, tree):
    """:func:`tree_map` where ``fn(name, leaf)`` receives the leaf's
    '/'-joined key path: dict keys, then list or tuple indices, as the
    reference's ``tree_map_with_path_names`` names them."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(t[k], (*path, str(k))) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            seq = [walk(v, (*path, str(i))) for i, v in enumerate(t)]
            return seq if isinstance(t, list) else tuple(seq)
        if t is None:
            return None
        return fn("/".join(path), t)

    return walk(tree, ())


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_size_bytes(tree) -> int:
    """Total bytes of every tensor leaf in ``tree``."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def tree_count_params(tree) -> int:
    """Total element count of every tensor leaf in ``tree``."""
    return int(sum(t.numel() for t in tree_leaves(tree)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree_leaves(tree)))
