"""SlotPool: the generic continuous-batching slot plane.

One slot-pool machine, many workloads — the runtime mirror of the paper's
one-large-programmable-macro argument (§II-A).  ``SlotPool`` owns
everything that is workload-independent about a pool of batch slots:

  * slot <-> tenant binding through :class:`~repro_torch.runtime.placement.
    SlotPlacement` (least-loaded shard alloc, per-shard pow-2 elastic
    grow/shrink with a ``min_capacity`` floor, cross-shard rebalance);
  * the elastic resize itself: pad/slice of every device state leaf along
    its declared slot axis, per shard block, plus the host-side remap;
  * migrate-on-idle rebalance at workload-declared barriers
    (``hop_barrier``), with the device row gather from
    :mod:`repro_torch.runtime.remap`;
  * idle-time prewarm of the next pow-2 capacity;
  * lifecycle observability: ``{prefix}resize`` / ``{prefix}rebalance``
    trace spans and structured events are emitted HERE, so every workload
    gets them for free (the KWS scheduler uses the unprefixed kinds).

The workload plugs in as a **client** object with a small duck-typed
surface (see :class:`SlotPoolClient`): a per-slot device-state tree
(nested tuples/lists of tensors),
the slot axis of each leaf, a shard-pinning hook, and a host-side remap
hook.  The pool never interprets the state — rows travel unchanged
through every structural operation, which is what makes resizes and
migrations bit-invisible to the tenants riding through them.

Structural operations (resize, rebalance) call the client's optional
``pre_structural`` hook first; an async execution plane installs its
epoch barrier there, so "drain every in-flight step before any slot
remap" is declared once instead of hand-rolled per workload.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import torch
import torch.nn.functional as F

from repro_torch.obs import Observability
from repro_torch.runtime.placement import SlotPlacement
from repro_torch.runtime.remap import perm_keep, remap_device_rows

__all__ = ["SlotPool", "SlotPoolClient", "next_pow2", "infer_slot_axes",
           "tree_map"]


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested tuples/lists (the state trees
    the pool drives), keeping the container types."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, *leaves) for leaves in zip(tree, *rest)
        )
    return fn(tree, *rest)


def infer_slot_axes(make_state, b1: int = 2, b2: int = 3):
    """Derive the slot axis of every leaf of a workload's state tree by
    shape-diffing ``make_state(batch)`` at two batch sizes, built on the
    ``meta`` device so nothing is materialized.  Leaves whose shape does
    not depend on the batch (shared scalar clocks, replicated params) map
    to ``-1`` ("not slot-indexed"); the pool leaves them untouched across
    resizes and rebalances."""
    with torch.device("meta"):
        s1 = make_state(b1)
        s2 = make_state(b2)

    def ax(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        return -1

    return tree_map(ax, s1, s2)


@runtime_checkable
class SlotPoolClient(Protocol):
    """Duck-typed workload surface the pool drives.

    Required:

    * ``device_state()`` — the per-slot device-state tree (leaves are
      tensors; non-slot leaves allowed when ``slot_axes`` marks them
      ``-1``).
    * ``set_device_state(state)`` — install the pool-transformed tree.
    * ``slot_axes()`` — tree of ints matching ``device_state()``: the
      slot axis of each leaf, ``-1`` for leaves with no slot axis.
    * ``shard(x, axis)`` — settle one tensor's slot ``axis`` onto the
      workload's placement (identity on one device).
    * ``apply_host_remap(remap, new_capacity)`` — ride the host-side
      planes (bookkeeping vectors, arenas, caches, slot handles) through
      a ``{old_slot: new_slot}`` remap at ``new_capacity`` rows.

    Optional (checked with ``getattr``):

    * ``warm(capacity)`` — run the workload's step once at ``capacity``
      slots (idle-time prewarm target).
    * ``pre_structural()`` — called before any structural mutation; an
      async plane installs its epoch barrier here.
    """

    def device_state(self): ...
    def set_device_state(self, state) -> None: ...
    def slot_axes(self): ...
    def shard(self, x, axis: int): ...
    def apply_host_remap(self, remap: dict[int, int],
                         new_capacity: int) -> None: ...


class SlotPool:
    """Elastic, shardable, observable pool of batch slots.

    ``capacity`` is the *ceiling*: the pool starts at ``initial_capacity``
    (default ``min_capacity``) and doubles on demand up to the ceiling;
    ``maybe_shrink`` halves it once occupancy falls to a quarter (never
    below ``min_capacity`` — set ``min_capacity == capacity`` to pin a
    fixed-size pool).  All capacities are multiples of ``n_shards`` and
    every resize scales the *per-shard* capacity, so rows never cross
    shard blocks outside the one deliberate ``rebalance`` path.  The
    port's shards are logical blocks of one device (a device mesh is
    queue item A.9).
    """

    def __init__(
        self,
        client: SlotPoolClient,
        capacity: int,
        *,
        initial_capacity: int | None = None,
        min_capacity: int | None = None,
        n_shards: int = 1,
        tenant_block: int | None = None,
        rebalance_threshold: int | None = 1,
        obs: Observability | None = None,
        event_prefix: str = "",
        noun: str = "stream",
        on_resize=None,
        on_rebalance=None,
        prewarm: bool = False,
        clock=time.perf_counter,
    ) -> None:
        S = n_shards
        assert S >= 1
        assert capacity % S == 0, (
            f"capacity {capacity} not a multiple of {S} shards"
        )
        self.client = client
        self.n_shards = S
        self.max_capacity = capacity
        self.min_capacity = (
            min_capacity if min_capacity is not None
            else S * min(2, capacity // S)
        )
        assert S <= self.min_capacity <= capacity
        assert self.min_capacity % S == 0
        cap0 = initial_capacity if initial_capacity is not None else (
            self.min_capacity
        )
        assert self.min_capacity <= cap0 <= capacity, (cap0, capacity)
        assert cap0 % S == 0
        if tenant_block is not None:
            # tenant blocks only nest across resizes when every per-shard
            # capacity the pool can visit is a power of two
            for c in (self.min_capacity, cap0, capacity):
                sc = c // S
                assert sc & (sc - 1) == 0, (
                    f"tenant pooling needs pow-2 per-shard capacities; "
                    f"got {sc} (capacity {c} over {S} shards)"
                )
        self._capacity = cap0
        self.placement = SlotPlacement(S, cap0 // S,
                                       tenant_block=tenant_block)
        if rebalance_threshold is not None:
            assert rebalance_threshold >= 1, rebalance_threshold
        self.rebalance_threshold = rebalance_threshold
        self.skew_dirty = False  # set on free; checked at hop barriers
        self.obs = obs if obs is not None else Observability.create()
        self._prefix = event_prefix
        self._noun = noun
        self._on_resize = on_resize
        self._on_rebalance = on_rebalance
        self._prewarm_enabled = prewarm
        self._clock = clock
        # an async plane reassigns this to its epoch barrier after
        # construction; None = synchronous workload, no barrier needed
        self.pre_structural = getattr(client, "pre_structural", None)

    # -- capacity ------------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Current pool size (<= ``max_capacity``)."""
        return self._capacity

    @property
    def shard_capacity(self) -> int:
        """Current per-shard pool size (== ``capacity`` with one shard)."""
        return self.placement.shard_capacity

    @property
    def active(self) -> int:
        """Occupied slot count."""
        return sum(s is not None for s in self.placement.slots)

    # -- tenant lifecycle ----------------------------------------------------

    def alloc(self, sid: int, model=None) -> int:
        """Claim a slot for ``sid`` on the least-loaded shard, growing the
        pool (pow-2 doubling) on demand; raises ``MemoryError`` at the
        capacity ceiling."""
        slot = self.placement.alloc(sid, model=model)
        while slot is None:
            if self._capacity >= self.max_capacity:
                raise MemoryError(
                    f"all {self.max_capacity} {self._noun} slots busy; "
                    f"close a {self._noun} first"
                )
            # one grow may still not open a compatible tenant block (a
            # one-block shard bound to another model), so keep doubling
            self.resize(min(self._capacity * 2, self.max_capacity))
            slot = self.placement.alloc(sid, model=model)
        return slot

    def free(self, slot: int) -> None:
        """Release one slot (placement only — the workload scrubs its own
        state rows).  Marks the pool skew-dirty: the next ``hop_barrier``
        re-levels shard occupancy if leave churn skewed it."""
        self.placement.free(slot)
        self.skew_dirty = True

    # -- elastic resize ------------------------------------------------------

    def resize(self, new_cap: int) -> None:
        """Per-shard pad/slice of the batched state to ``new_cap`` slots.

        Rows travel unchanged and never cross shard blocks (a slot's math
        never depends on the batch size or its neighbors), so resizes are
        invisible to the tenants riding through them and cost zero
        collective communication.
        """
        old = self._capacity
        if new_cap == old:
            return
        if self.pre_structural is not None:
            self.pre_structural()  # remaps must never race in-flight steps
        with self.obs.trace.span(self._prefix + "resize",
                                 old=old, new=new_cap):
            self._resize_inner(new_cap)

    def _resize_inner(self, new_cap: int) -> None:
        old = self._capacity
        S = self.n_shards
        old_sc, new_sc = old // S, new_cap // S
        if new_cap > old:
            remap = self.placement.grow(new_sc)
            moves = None
        else:
            # compact tenants out of each shard's doomed upper slots, then
            # slice every shard block; vacated destinations are already
            # zero (scrubbed by the workload on free)
            moves, remap = self.placement.shrink(new_sc)

        def adjust(a, ax):
            if ax < 0:
                return a  # not slot-indexed (shared clocks, replicated)
            m = torch.movedim(a, ax, 0) if ax else a
            if moves is None:
                m2 = m.reshape(S, old_sc, *m.shape[1:])
                # F.pad lists (left, right) pairs from the LAST axis back
                m2 = F.pad(m2, (0, 0) * (m.dim() - 1)
                           + (0, new_sc - old_sc))
            else:
                m = m.clone()
                for dst, src in moves:
                    m[dst] = m[src]
                m2 = m.reshape(S, old_sc, *m.shape[1:])[:, :new_sc]
            out = m2.reshape(S * new_sc, *m.shape[1:])
            if ax:
                out = torch.movedim(out, 0, ax)
            return self.client.shard(out.contiguous(), ax)

        self.client.set_device_state(tree_map(
            adjust, self.client.device_state(), self.client.slot_axes()
        ))
        # the host-side planes ride the same placement remap, so a
        # tenant's bookkeeping rows stay glued to its slot
        self.client.apply_host_remap(remap, new_cap)
        self._capacity = new_cap
        if self._on_resize is not None:
            self._on_resize(new_cap)
        self.obs.events.emit(self._prefix + "resize", old=old, new=new_cap,
                             active=self.active, shards=S)

    def maybe_shrink(self) -> None:
        """Halve the pool while occupancy sits at or below a quarter,
        floored by ``min_capacity`` and — because shrink compaction is
        per-shard — the fullest shard's tenant count.  The rebalance plane
        levels occupancy at hop barriers, so under churn this floor
        settles at ceil(active / S) instead of wherever the most crowded
        shard happens to sit."""
        S = self.n_shards
        sc = self._capacity // S
        min_sc = self.min_capacity // S
        active = self.active
        while sc > min_sc and active <= (S * sc) // 4:
            sc //= 2
        sc = max(sc, min_sc, next_pow2(max(self.placement.occupancy())))
        while S * sc < self._capacity:
            try:
                self.resize(S * sc)
                return
            except ValueError:
                # tenant-block packing can refuse a depth occupancy alone
                # would allow (blocks never split across models); retry
                # shallower.  Un-pooled placement never raises here.
                sc *= 2

    # -- cross-shard rebalance -----------------------------------------------

    def maybe_rebalance(self) -> bool:
        """Migrate-on-idle: level shard occupancy with cross-shard slot
        moves when churn has skewed it past ``rebalance_threshold``.

        The device half is one row gather per state leaf
        (:func:`repro_torch.runtime.remap.remap_device_rows`) — rows travel
        unchanged, so the migration is bit-invisible to the tenants
        riding through it; the host half is the same remap contract every
        resize already takes.  Returns True when any row moved (the
        caller then re-checks the shrink, whose per-shard floor the
        migration just lifted).
        """
        thr = self.rebalance_threshold
        if self.n_shards == 1 or thr is None:
            return False
        occ = self.placement.occupancy()
        if max(occ) - min(occ) <= thr:
            return False
        if self.pre_structural is not None:
            self.pre_structural()
        moves, remap = self.placement.rebalance()
        if not moves:
            return False
        with self.obs.trace.span(self._prefix + "rebalance",
                                 moves=len(moves)):
            self._execute_rebalance(moves, remap, occ)
        return True

    def _execute_rebalance(self, moves, remap, occ) -> None:
        cap = self._capacity
        perm, keep = perm_keep(remap, cap)

        def gather(a, ax):
            if ax < 0:
                return a
            out = remap_device_rows(a, perm, keep, axis=ax)
            return self.client.shard(out, ax)

        self.client.set_device_state(tree_map(
            gather, self.client.device_state(), self.client.slot_axes()
        ))
        self.client.apply_host_remap(remap, cap)
        if self._on_rebalance is not None:
            self._on_rebalance(len(moves))
        self.obs.events.emit(
            self._prefix + "rebalance", moves=len(moves),
            shards=self.n_shards, occupancy_before=list(occ),
            occupancy_after=list(self.placement.occupancy()),
        )

    # -- workload-declared barriers ------------------------------------------

    def hop_barrier(self) -> None:
        """Structural housekeeping at a workload step boundary:
        rebalance-on-skew, then the shrink the migration may have
        unpinned.  Async workloads call this behind their epoch barrier
        (the pool's ``pre_structural`` hook covers the paths that reach
        structural mutations any other way)."""
        if self.skew_dirty:
            self.skew_dirty = False
            if self.maybe_rebalance():
                self.maybe_shrink()

    def maybe_prewarm(self) -> None:
        """Idle-time prewarm: run the NEXT pow-2 capacity's step via the
        client's ``warm`` hook while the workload is starved, so the
        first step after a grow pays no first-call spike."""
        if not self._prewarm_enabled:
            return
        warm = getattr(self.client, "warm", None)
        if warm is None:
            return
        nxt = min(self._capacity * 2, self.max_capacity)
        if nxt > self._capacity:
            warm(nxt)
