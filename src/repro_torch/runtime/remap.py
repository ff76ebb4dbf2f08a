"""Row-remap contract of the slot-pool plane: host and device halves.

Every structural pool operation (elastic resize, cross-shard rebalance)
reduces to ONE slot remap ``{old_slot: new_slot}`` that the workload's
state must ride through:

  * **host half** — :func:`remap_rows` reindexes any numpy per-slot plane
    (bookkeeping vectors, detector state, the ``RingArena``'s
    ``apply_remap`` is built on the same contract) with one vectorized
    gather; rows without a surviving tenant reset to ``fill``.
  * **device half** — :func:`remap_device_rows` permutes the slot axis of
    a device-resident state tensor: one ``index_select`` plus a mask, so
    rows without a surviving tenant scrub to zero.  Over the shards of a
    mesh (:class:`~repro_torch.launch.mesh.ShardRows`) each destination
    shard's block is built on its own device from the rows of the source
    shards that feed it.
  * :func:`perm_keep` converts the remap dict into the dense
    ``(perm, keep)`` arrays the device gather consumes: ``out[i] =
    x[perm[i]] where keep[i] else 0``.

``SlotPool`` drives both halves; workloads only declare which axis of
each state leaf is the slot axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import ShardRows

__all__ = ["remap_rows", "perm_keep", "remap_device_rows"]


def remap_rows(a: np.ndarray, remap: dict[int, int], new_rows: int,
               fill=0) -> np.ndarray:
    """Reindex the leading axis through a slot remap (one vectorized
    gather); rows without a surviving tenant reset to ``fill``."""
    out = np.full((new_rows,) + a.shape[1:], fill, a.dtype)
    if remap:
        olds = np.fromiter(remap.keys(), np.int64, len(remap))
        news = np.fromiter(remap.values(), np.int64, len(remap))
        out[news] = a[olds]
    return out


def perm_keep(remap: dict[int, int],
              capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Densify ``{old_slot: new_slot}`` into the ``(perm, keep)`` pair of
    the device gather: ``perm[new] = old`` for every surviving tenant,
    ``keep`` False rows scrub to zero."""
    perm = np.arange(capacity, dtype=np.int64)
    keep = np.zeros(capacity, bool)
    for old, new in remap.items():
        perm[new] = old
        keep[new] = True
    return perm, keep


def remap_device_rows(x, perm: np.ndarray, keep: np.ndarray, *,
                      axis: int = 0):
    """Permute the slot ``axis`` of one device state tensor: ``out[i] =
    x[perm[i]] where keep[i] else 0`` along that axis.  For a
    :class:`ShardRows` the result is one too, each shard's part on its
    own device."""
    if isinstance(x, ShardRows):
        return _remap_shard_rows(x, perm, keep, axis)
    p = torch.as_tensor(perm, dtype=torch.int64, device=x.device)
    k = torch.as_tensor(keep, dtype=torch.bool, device=x.device)
    out = torch.index_select(x, axis, p)
    shape = [1] * x.dim()
    shape[axis] = -1
    return torch.where(k.reshape(shape), out, torch.zeros_like(out))


def _remap_shard_rows(x: ShardRows, perm: np.ndarray, keep: np.ndarray,
                      axis: int) -> ShardRows:
    """:func:`remap_device_rows` over shards: destination shard ``d``'s
    rows start as zeros on its device, and every source shard that feeds
    it gives one ``index_select`` on the source's device, copied over and
    written in with one ``index_copy_``.  A copy between two cards runs
    after the work queued on the source card (torch orders it), and
    torch routes it through host memory where the cards have no peer
    access."""
    n = x.parts[0].shape[axis]
    out = []
    for d, dst in enumerate(x.parts):
        p, k = perm[d * n:(d + 1) * n], keep[d * n:(d + 1) * n]
        part = torch.zeros_like(dst)
        for s, src in enumerate(x.parts):
            sel = np.nonzero(k & (p // n == s))[0]
            if sel.size == 0:
                continue
            rows = torch.index_select(src, axis, torch.as_tensor(
                p[sel] % n, device=src.device))
            part.index_copy_(axis, torch.as_tensor(sel, device=dst.device),
                             rows.to(dst.device))
        out.append(part)
    return ShardRows(out)
