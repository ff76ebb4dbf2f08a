"""The continuous-batching slot-pool plane, ported from the reference's
``repro.runtime``:

  * :mod:`repro_torch.runtime.pool` — :class:`SlotPool`: slot<->tenant
    binding, pow-2 elastic grow/shrink with a ``min_capacity`` floor,
    idle-time prewarm, pool-emitted lifecycle observability;
  * :mod:`repro_torch.runtime.placement` — :class:`SlotPlacement`:
    slot->shard mapping over contiguous per-shard blocks (the shards of a
    ``launch.mesh.make_stream_mesh`` mesh, on one device or several),
    cross-shard rebalance planning, single-model tenant blocks;
  * :mod:`repro_torch.runtime.remap` — the row-remap contract (host
    ``remap_rows``, device ``remap_device_rows``/``perm_keep``);
  * :mod:`repro_torch.runtime.async_plane` — the async execution plane:
    :class:`InFlightQueue` (double-buffered dispatch, FIFO fold, epoch
    barriers) and :class:`IngestPump` (pushes landed from a worker
    thread).
"""
from repro_torch.runtime.async_plane import InFlightQueue, IngestPump
from repro_torch.runtime.placement import SlotPlacement
from repro_torch.runtime.pool import (
    SlotPool,
    SlotPoolClient,
    infer_slot_axes,
    next_pow2,
)
from repro_torch.runtime.remap import perm_keep, remap_device_rows, remap_rows

__all__ = [
    "InFlightQueue",
    "IngestPump",
    "SlotPlacement",
    "SlotPool",
    "SlotPoolClient",
    "infer_slot_axes",
    "next_pow2",
    "perm_keep",
    "remap_device_rows",
    "remap_rows",
]
