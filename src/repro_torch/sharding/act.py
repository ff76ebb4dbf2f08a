"""Activation sharding constraints with logical axis names.

The port of the reference's ``repro/sharding/act.py``.  Model code never
imports a mesh; it annotates activations with *logical* axes ("dp" batch,
"tp" tensor/model).  The dry run installs a policy mapping logical ->
mesh axes before it runs a step; without a policy (tests, the engine, the
trainer) constraints are no-ops.  Dims that do not divide the mesh axis
are left unconstrained (the reference's fallback).

Under a policy, :func:`constrain` redistributes a ``DTensor`` and its
gradient to the layout (the counterpart of ``with_sharding_constraint``);
a plain tensor passes through untouched.  Where the reference leaves the
rest to its partitioner, the port's model code calls the helpers below
on DTensors (:func:`sharded`): :func:`shard_map` runs a function on each
device's shards, :func:`matmul` a Megatron product, :func:`gather_dp`
gathers an FSDP-stored weight, :func:`split_columns` splits a fused
projection, :func:`reshape` reshapes where DTensor's own rule would
split a sharded dim unevenly, :func:`like` reduces a gradient to its
param's layout and :func:`sum_zero` starts a partial sum.  None of them
changes what a plain tensor computes.
"""
from __future__ import annotations

import math

import torch

_POLICY: dict | None = None


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``) or of a
    mesh that reports ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def set_policy(mesh, dp_axes, tp_axis="model") -> None:
    """tp_axis=None disables TP constraints (dp_only/FSDP profile)."""
    global _POLICY
    _POLICY = {"mesh": mesh, "dp": dp_axes, "tp": tp_axis}


def clear_policy() -> None:
    global _POLICY
    _POLICY = None


def _axis_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def axis_size(name: str) -> int | None:
    """Size of a logical axis under the active policy (None = no policy)."""
    if _POLICY is None or _POLICY.get(name) is None:
        return None
    return _axis_size(_POLICY["mesh"], _POLICY[name])


def logical_spec(shape, *logical) -> tuple:
    """The mesh axes per dim for ``constrain(x, *logical)`` under the
    active policy: a dim that the axis does not divide, or that is
    smaller than it, stays unsharded (None)."""
    mesh = _POLICY["mesh"]
    spec = []
    for dim, name in zip(shape, logical):
        axes = None if name is None else _POLICY.get(name)
        if axes is not None and dim % _axis_size(mesh, axes) == 0 \
                and dim >= _axis_size(mesh, axes):
            spec.append(axes)
        else:
            spec.append(None)
    return tuple(spec)


def placements(mesh, spec) -> tuple:
    """DTensor placements on ``mesh`` for a spec (one entry per tensor dim:
    None, an axis name or a tuple of them): ``Shard(d)`` on every mesh
    axis that dim d names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def policy():
    """The active policy ({"mesh", "dp", "tp"}) or None."""
    return _POLICY


def sharded(x) -> bool:
    """Whether ``x`` is a DTensor under an active policy (the dry run)."""
    return _POLICY is not None and hasattr(x, "placements")


def spec_placements(ndim: int, *logical) -> tuple:
    """``placements`` on the policy's mesh of a logical layout given per
    dim as mesh axes (None, an axis name or a tuple), padded with None to
    ``ndim`` dims."""
    return placements(_POLICY["mesh"],
                      tuple(logical) + (None,) * (ndim - len(logical)))


def shard_map(fn, args, in_placements, out_placements):
    """``fn`` on each device's shards of ``args`` (the counterpart of
    ``shard_map``): each ``DTensor`` arg is redistributed to its entry of
    ``in_placements`` (None: passed as it is) and handed to ``fn`` as its
    local tensor, a ``DTensor`` with None as its whole value; each tensor
    ``fn`` returns becomes a ``DTensor`` with its entry of
    ``out_placements``.  Gradients flow through both ends: along a mesh
    dim over which the computation is split (an input or an output is
    sharded or partial there), the local gradient of an input that is
    replicated there is a partial sum, as the transpose of ``shard_map``
    sums it over the axis."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = _POLICY["mesh"]
    outs = (out_placements if isinstance(out_placements[0], tuple)
            else (out_placements,))
    split = {i for pls in outs for i, p in enumerate(pls)
             if not p.is_replicate()}
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor) and pl is not None:
            split.update(i for i, p in enumerate(pl) if p.is_shard())
    local = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor):
            if pl is None:
                a = a.full_tensor()
            else:
                if tuple(a.placements) != tuple(pl):
                    a = a.redistribute(mesh, tuple(pl))
                a = a.to_local(grad_placements=tuple(
                    Partial() if p.is_replicate() and i in split else p
                    for i, p in enumerate(pl)))
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


def shard_index(mesh, axes) -> tuple[int, int]:
    """(this device's index, count) along ``axes`` (a name or a tuple of
    names, the first major): the shard of a dim split over them."""
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def gather_dp(w):
    """A weight as the device computes with it: under a policy, a DTensor
    that FSDP stores sharded over the DP axes is all-gathered over them
    (its gradient is reduce-scattered back); anything else is returned
    as it is."""
    if not sharded(w) or not _POLICY["dp"]:
        return w
    from torch.distributed.tensor import Replicate

    dp = _POLICY["dp"]
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    names = list(mesh_axes(_POLICY["mesh"]))
    pl = tuple(Replicate() if names[i] in dp and p.is_shard() else p
               for i, p in enumerate(w.placements))
    if pl == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def sum_zero(x):
    """A float32 0-d zero on ``x``'s device; under a policy, for a
    DTensor ``x``, laid out as ``x.sum()`` is (a partial sum over every
    mesh dim that shards ``x``), so that sums accumulated into it are
    reduced once, when the total is read, whatever DTensor's planner
    would do with a replicated zero."""
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    if not sharded(x):
        return z
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl = tuple(Partial() if p.is_shard() else Replicate()
               for p in x.placements)
    return DTensor.from_local(z, x.device_mesh, pl, run_check=False)


def like(g, ref):
    """``g`` in the layout of ``ref`` under a policy (a gradient reduced
    to its param's placements: an all-reduce over DP, a reduce-scatter
    for FSDP storage); ``g`` itself otherwise."""
    if not sharded(g) or tuple(g.placements) == tuple(ref.placements):
        return g
    return g.redistribute(ref.device_mesh, tuple(ref.placements))


def split_columns(w, n: int):
    """The two column blocks ``w[..., :n]`` and ``w[..., n:]`` of a fused
    projection.  Under a policy, a DTensor sharded along its columns is
    gathered along them, split, and each block sharded back the same way
    (each device then holds matching channels of both blocks, as a
    Megatron layout pairs them); otherwise plain slices."""
    if not sharded(w):
        return w[..., :n], w[..., n:]
    from torch.distributed.tensor import Replicate

    last = w.ndim - 1
    pl = tuple(w.placements)
    full = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    wf = w.redistribute(w.device_mesh, full)
    return tuple(b.redistribute(w.device_mesh, pl)
                 for b in (wf[..., :n], wf[..., n:]))


def matmul(x, w, product=None):
    """``x @ w`` for a weight ``w`` (K, N) (FSDP storage gathered first).
    Under a policy, on DTensors, each device multiplies its shards
    (:func:`shard_map`), as Megatron's layers do: over a mesh axis that
    shards N (column-parallel) ``x`` is whole and the product is sharded
    on N; over one that shards K (row-parallel) ``x`` is sharded on K and
    the product is a partial sum; over any other axis ``x`` keeps its
    (batch) sharding.  ``product(x_local, w_local)`` is the local product
    (default ``torch.matmul``)."""
    product = product or torch.matmul
    if _POLICY is None:
        return product(x, w)
    w = gather_dp(w)
    if not (sharded(x) and sharded(w)):
        return product(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.ndim - 1
    x_pl, out_pl = [], []
    for px, pw in zip(x.placements, w.placements):
        if pw.is_shard(w.ndim - 1):           # column-parallel
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
        elif pw.is_shard(w.ndim - 2):         # row-parallel
            x_pl.append(Shard(last))
            out_pl.append(Partial())
        elif px.is_shard() and px.dim != last:
            x_pl.append(px)
            out_pl.append(px)
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
    return shard_map(product, (x, w), (tuple(x_pl), tuple(w.placements)),
                     tuple(out_pl))


def reshape(x, *shape):
    """``x.reshape(*shape)``; under a policy, a DTensor whose sharded dim
    the new shape cannot split evenly (8 kv heads over a 16-wide axis) is
    first gathered along every sharded dim from the first dim that
    changes, as the reference's partitioner gathers it."""
    if not sharded(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate

    try:
        y = x.reshape(*shape)
    except RuntimeError:
        first = 0
        while first < min(x.ndim, len(shape)) and \
                x.shape[first] == shape[first]:
            first += 1
        pl = tuple(Replicate() if p.is_shard() and p.dim >= first else p
                   for p in x.placements)
        y = x.redistribute(x.device_mesh, pl).reshape(*shape)
    # the gradient comes back in the output's layout, so that the
    # backward's reshape splits nothing unevenly either
    return _GradLike.apply(y, tuple(
        Replicate() if p.is_partial() else p for p in y.placements))


class _GradLike(torch.autograd.Function):
    """The identity; its backward redistributes the gradient to the
    given placements."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def constrain(x, *logical):
    """constrain(x, 'dp', None, 'tp', None): ``x`` redistributed to the
    layout under the active policy, and its gradient too, as the
    reference's ``with_sharding_constraint`` constrains the cotangent
    (so that a partial-sum gradient is reduced here, where the reference
    reduces it, and not wherever DTensor's planner would); ``x`` itself
    with no policy or when it is not a ``DTensor``."""
    if _POLICY is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = spec_placements(x.ndim, *logical_spec(x.shape, *logical))
    if tuple(x.placements) != want:
        x = x.redistribute(_POLICY["mesh"], want)
    if not x.requires_grad:
        return x
    return _GradLike.apply(x, want)
