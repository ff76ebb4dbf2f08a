"""Slot -> shard placement for the generic continuous-batching runtime.

``SlotPlacement`` is pure bookkeeping (plain python ints) shared by every
workload that rides the :class:`repro_torch.runtime.pool.SlotPool`: the KWS
streaming scheduler (``repro_torch.stream``) places their per-slot state through this one class.
It grew up inside ``stream/state.py`` (PRs 3, 5, 9) and moved here verbatim
when the slot-pool plane was extracted — the mesh/block invariants below
are workload-agnostic:

  * one logical pool of ``n_shards * shard_capacity`` rows; shard ``s``
    owns the contiguous block ``[s * shard_capacity, (s+1) *
    shard_capacity)``;
  * ``alloc`` -> least-loaded shard, lowest free local slot;
  * ``grow``/``shrink`` scale the per-shard capacity — a resize never
    moves a row across devices;
  * ``rebalance`` is the ONE deliberate cross-shard path (migrate-on-idle
    row moves at workload-defined barriers);
  * ``tenant_block`` keeps aligned slot blocks single-model so pooled
    kernels can gather one weight row per block.
"""
from __future__ import annotations

__all__ = ["SlotPlacement"]


class SlotPlacement:
    """Slot -> shard mapping for the mesh-wide slot pool.

    The pool's batch axis is one global array of ``n_shards *
    shard_capacity`` rows; under a mesh sharding over the ``"data"`` axis,
    shard ``s`` owns the contiguous row block ``[s * shard_capacity, (s +
    1) * shard_capacity)``.  All placement decisions respect that block
    structure so *no resize or allocation ever moves a row across
    devices*:

      * ``alloc`` places a joining stream on the least-loaded shard
        (lowest shard wins ties) at its lowest free local slot — with one
        shard this degenerates to "lowest free slot", the pre-mesh
        behavior;
      * ``grow``/``shrink`` change the *per-shard* capacity: a grow
        appends rows at the end of every shard block, a shrink compacts
        each shard's tenants into its own surviving local slots and drops
        the block tails.  A resize never moves a row across devices,
        which is why an elastic resize under sharding costs zero
        collective communication;
      * ``rebalance`` is the ONE deliberate cross-shard path — the
        software twin of re-laying-out the paper's flexible ping-pong
        feature SRAM when the workload shape changes (§II-E): at hop
        boundaries, churn-induced occupancy skew is leveled by migrating
        tenants from over-full shards to under-full ones, so the shrink
        floor is ``ceil(active / n_shards)`` per shard instead of the
        fullest shard's tenant count.

    **Multi-tenant mode** (``tenant_block`` set): every shard block is
    further partitioned into aligned *tenant blocks* of ``min(tenant_block,
    shard_capacity)`` slots, and placement keeps each tenant block
    single-model — the invariant that lets the pooled kernels gather ONE
    weight row per grid cell (`kernels/hop_megakernel.py` ``pooled``).
    A block's model binding is *derived* (the model of any occupied slot;
    an empty block is unbound), which makes it automatically correct
    across grow (local indices are preserved and old blocks nest inside
    new ones) and shrink (new blocks are equal-or-finer partitions of the
    surviving region).

    The placement is pure bookkeeping (plain python ints); the scheduler
    applies the returned remaps/moves to the batched device arrays.
    """

    def __init__(self, n_shards: int, shard_capacity: int,
                 tenant_block: int | None = None) -> None:
        assert n_shards >= 1 and shard_capacity >= 1
        # power-of-two so tenant blocks nest across pow-2 grow/shrink
        assert tenant_block is None or (
            tenant_block >= 1 and tenant_block & (tenant_block - 1) == 0
        )
        self.n_shards = n_shards
        self.shard_capacity = shard_capacity
        self.tenant_block = tenant_block
        self.slots: list[int | None] = [None] * (n_shards * shard_capacity)
        # model key per slot (None when free / untracked); parallel to
        # ``slots`` and remapped alongside it by every placement op
        self.slot_model: list = [None] * (n_shards * shard_capacity)

    @property
    def capacity(self) -> int:
        return self.n_shards * self.shard_capacity

    @property
    def block_size(self) -> int | None:
        """Effective tenant-block size (None in single-model mode)."""
        if self.tenant_block is None:
            return None
        return min(self.tenant_block, self.shard_capacity)

    def shard_of(self, slot: int) -> int:
        return slot // self.shard_capacity

    def occupancy(self) -> list[int]:
        """Tenant count per shard."""
        occ = [0] * self.n_shards
        for slot, sid in enumerate(self.slots):
            if sid is not None:
                occ[self.shard_of(slot)] += 1
        return occ

    def _block_model(self, start: int, tbe: int,
                     slots=None, slot_model=None):
        """Derived model binding of the block at ``start``: the model of
        any occupied slot (single-model invariant), None when empty."""
        slots = self.slots if slots is None else slots
        slot_model = self.slot_model if slot_model is None else slot_model
        for s in range(start, start + tbe):
            if slots[s] is not None:
                return slot_model[s]
        return None

    def block_models(self) -> dict[int, object]:
        """{block_start: model} for every non-empty tenant block."""
        tbe = self.block_size
        assert tbe is not None, "single-model placement has no blocks"
        out = {}
        for start in range(0, self.capacity, tbe):
            m = self._block_model(start, tbe)
            if m is not None:
                out[start] = m
        return out

    def alloc(self, sid: int, model=None) -> int | None:
        """Place ``sid`` on the least-loaded shard; None when pool full.

        With ``tenant_block`` set, only slots inside a block already bound
        to ``model`` (or an empty block, which this alloc binds) are
        eligible — shards are scanned in least-loaded order, preferring
        partially-filled compatible blocks over opening a fresh one.
        """
        occ = self.occupancy()
        c = self.shard_capacity
        order = sorted(range(self.n_shards), key=lambda s: (occ[s], s))
        if self.tenant_block is None:
            for sh in order:
                if occ[sh] == c:
                    continue
                base = sh * c
                for loc in range(c):
                    if self.slots[base + loc] is None:
                        self.slots[base + loc] = sid
                        self.slot_model[base + loc] = model
                        return base + loc
            return None
        tbe = self.block_size
        # pass 1: a compatible partially-filled block on the least-loaded
        # shard; pass 2: open an empty block
        for want_empty in (False, True):
            for sh in order:
                if occ[sh] == c:
                    continue
                base = sh * c
                for start in range(base, base + c, tbe):
                    bm = self._block_model(start, tbe)
                    ok = (bm is None) if want_empty else (
                        bm is not None and bm == model
                    )
                    if not ok:
                        continue
                    for s in range(start, start + tbe):
                        if self.slots[s] is None:
                            self.slots[s] = sid
                            self.slot_model[s] = model
                            return s
        return None

    def free(self, slot: int) -> None:
        assert self.slots[slot] is not None
        self.slots[slot] = None
        self.slot_model[slot] = None

    def grow(self, new_shard_capacity: int) -> dict[int, int]:
        """Grow every shard block; returns {old_slot: new_slot} remap.

        Tenant blocks stay single-model for free: local indices are
        preserved, and the old blocks (size ``min(tb, old_c)``) nest
        inside the new ones (size ``min(tb, c)``) — when ``old_c < tb``
        the whole old shard was one block, so the containing new block
        inherits a single model either way.
        """
        old_c, c = self.shard_capacity, new_shard_capacity
        assert c > old_c
        remap: dict[int, int] = {}
        slots: list[int | None] = [None] * (self.n_shards * c)
        models: list = [None] * (self.n_shards * c)
        for slot, sid in enumerate(self.slots):
            new_slot = self.shard_of(slot) * c + slot % old_c
            slots[new_slot] = sid
            models[new_slot] = self.slot_model[slot]
            remap[slot] = new_slot
        self.slots, self.slot_model = slots, models
        self.shard_capacity = c
        return remap

    def shrink(
        self, new_shard_capacity: int
    ) -> tuple[list[tuple[int, int]], dict[int, int]]:
        """Shrink every shard block to ``new_shard_capacity`` local slots.

        Returns ``(moves, remap)``: ``moves`` are (dst, src) row copies in
        the OLD global indexing — each within one shard block — that
        compact tenants out of the doomed upper local slots; ``remap`` is
        {old_slot: new_slot} for every surviving tenant after the slice.
        """
        old_c, c = self.shard_capacity, new_shard_capacity
        assert c < old_c
        if self.tenant_block is not None:
            return self._shrink_tenant(c)
        moves: list[tuple[int, int]] = []
        moved: dict[int, int] = {}  # original old slot -> post-move old slot
        for sh in range(self.n_shards):
            base = sh * old_c
            if sum(s is not None for s in
                   self.slots[base : base + old_c]) > c:
                raise ValueError(
                    f"shard {sh} holds more than {c} tenants; cross-shard "
                    "relocation is not allowed"
                )
            free_low = [
                base + loc for loc in range(c)
                if self.slots[base + loc] is None
            ]
            for loc in range(c, old_c):
                sid = self.slots[base + loc]
                if sid is None:
                    continue
                dst = free_low.pop(0)
                moves.append((dst, base + loc))
                moved[base + loc] = dst
                self.slots[dst] = sid
                self.slot_model[dst] = self.slot_model[base + loc]
                self.slots[base + loc] = None
                self.slot_model[base + loc] = None
        return moves, self._commit_shrink(
            self.slots, self.slot_model, moved, c
        )

    def _commit_shrink(self, slots, models, moved, c):
        """Slice each shard's surviving region and build the {original
        old slot: new slot} remap (shared by both shrink flavors)."""
        old_c = self.shard_capacity
        remap: dict[int, int] = {}
        new_slots: list[int | None] = [None] * (self.n_shards * c)
        new_models: list = [None] * (self.n_shards * c)
        survivor_new = {}  # post-move old slot -> new slot
        for sh in range(self.n_shards):
            for loc in range(c):
                sid = slots[sh * old_c + loc]
                new_slots[sh * c + loc] = sid
                new_models[sh * c + loc] = models[sh * old_c + loc]
                if sid is not None:
                    survivor_new[sh * old_c + loc] = sh * c + loc
        for old_slot, new_slot in survivor_new.items():
            remap[old_slot] = new_slot
        for orig, interim in moved.items():
            remap[orig] = survivor_new[interim]
        self.slots, self.slot_model = new_slots, new_models
        self.shard_capacity = c
        return remap

    def _shrink_tenant(
        self, c: int
    ) -> tuple[list[tuple[int, int]], dict[int, int]]:
        """Tenant-aware shrink: compact doomed-region tenants into
        surviving blocks WITHOUT splitting a single-model block.  The
        whole plan runs over copies first, so an impossible shrink raises
        before any placement state mutates (the scheduler treats that as
        "stay at the current capacity").
        """
        old_c = self.shard_capacity
        tbe = min(self.tenant_block, c)
        slots = list(self.slots)
        models = list(self.slot_model)
        moves: list[tuple[int, int]] = []
        moved: dict[int, int] = {}
        for sh in range(self.n_shards):
            base = sh * old_c
            for loc in range(c, old_c):
                src = base + loc
                sid = slots[src]
                if sid is None:
                    continue
                m = models[src]
                dst = None
                for want_empty in (False, True):
                    for start in range(base, base + c, tbe):
                        bm = self._block_model(start, tbe, slots, models)
                        ok = (bm is None) if want_empty else (
                            bm is not None and bm == m
                        )
                        if not ok:
                            continue
                        dst = next(
                            (s for s in range(start, start + tbe)
                             if slots[s] is None), None
                        )
                        if dst is not None:
                            break
                    if dst is not None:
                        break
                if dst is None:
                    raise ValueError(
                        f"shard {sh} cannot pack its tenants into {c} "
                        "slots without splitting a tenant block"
                    )
                moves.append((dst, src))
                moved[src] = dst
                slots[dst], models[dst] = sid, m
                slots[src] = models[src] = None
        return moves, self._commit_shrink(slots, models, moved, c)

    def rebalance(self) -> tuple[list[tuple[int, int]], dict[int, int]]:
        """Plan cross-shard migrations that level shard occupancy.

        Tenants move from shards above ``target = ceil(active /
        n_shards)`` to shards below it until no shard exceeds the target
        — the leveled pool can then shrink to ``ceil(active / S)`` local
        slots where the skewed pool was pinned at the fullest shard's
        tenant count.  Donors give up their *highest* occupied local slot
        (freeing the block tail a later shrink slices off); receivers
        fill their *lowest* free local slot.  Deterministic: ties break
        to the lowest shard index.

        Returns ``(moves, remap)`` with capacity unchanged: ``moves`` are
        (dst, src) row copies in the current global indexing — each one
        crossing a shard block, unlike every other placement operation —
        and ``remap`` is {original_slot: current_slot} for EVERY tenant
        (identity when unmoved), i.e. ``RingArena.apply_remap``'s
        contract.
        """
        if self.tenant_block is not None:
            return self._rebalance_tenant()
        c = self.shard_capacity
        occ = self.occupancy()
        active = sum(occ)
        target = -(-active // self.n_shards) if active else 0
        moves: list[tuple[int, int]] = []
        while True:
            hi = max(range(self.n_shards), key=lambda s: (occ[s], -s))
            if occ[hi] <= target:
                break
            lo = min(range(self.n_shards), key=lambda s: (occ[s], s))
            src = next(hi * c + loc for loc in range(c - 1, -1, -1)
                       if self.slots[hi * c + loc] is not None)
            dst = next(lo * c + loc for loc in range(c)
                       if self.slots[lo * c + loc] is None)
            self.slots[dst] = self.slots[src]
            self.slot_model[dst] = self.slot_model[src]
            self.slots[src] = None
            self.slot_model[src] = None
            moves.append((dst, src))
            occ[hi] -= 1
            occ[lo] += 1
        # every move is a single hop (donor shards only lose, receiver
        # shards only gain), so {dst: src} inverts to the original slots
        came_from = {dst: src for dst, src in moves}
        remap = {
            came_from.get(slot, slot): slot
            for slot, sid in enumerate(self.slots) if sid is not None
        }
        return moves, remap

    def _rebalance_tenant(
        self,
    ) -> tuple[list[tuple[int, int]], dict[int, int]]:
        """Tenant-aware rebalance: migrate WHOLE tenant blocks (offset-
        preserving) from the fullest shard into empty aligned blocks on
        the emptiest shard — slot-level moves would split single-model
        blocks.  Each migration strictly decreases the occupancy
        potential sum(occ^2) (it requires ``occ[hi] - occ[lo] > n``), so
        the loop terminates; a block can move more than once across
        rounds, so ``came_from`` chain-resolves back to original slots.
        """
        c = self.shard_capacity
        tbe = self.block_size
        occ = self.occupancy()
        moves: list[tuple[int, int]] = []
        came_from: dict[int, int] = {}
        while True:
            hi = max(range(self.n_shards), key=lambda s: (occ[s], -s))
            lo = min(range(self.n_shards), key=lambda s: (occ[s], s))
            # smallest non-empty block on the donor: cheapest to move and
            # the most likely to satisfy the potential-decrease gate
            best = None
            for start in range(hi * c, (hi + 1) * c, tbe):
                n = sum(1 for s in range(start, start + tbe)
                        if self.slots[s] is not None)
                if n and (best is None or n < best[1]):
                    best = (start, n)
            if best is None:
                break
            src_start, n = best
            if occ[hi] - occ[lo] <= n:
                break
            dst_start = next(
                (s0 for s0 in range(lo * c, (lo + 1) * c, tbe)
                 if all(self.slots[s] is None
                        for s in range(s0, s0 + tbe))),
                None,
            )
            if dst_start is None:
                break
            for off in range(tbe):
                src, dst = src_start + off, dst_start + off
                if self.slots[src] is None:
                    continue
                self.slots[dst] = self.slots[src]
                self.slot_model[dst] = self.slot_model[src]
                self.slots[src] = None
                self.slot_model[src] = None
                moves.append((dst, src))
                came_from[dst] = came_from.pop(src, src)
            occ[hi] -= n
            occ[lo] += n
        remap = {
            came_from.get(slot, slot): slot
            for slot, sid in enumerate(self.slots) if sid is not None
        }
        return moves, remap
