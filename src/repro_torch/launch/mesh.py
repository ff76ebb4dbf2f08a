"""The stream slot pool's mesh: S logical shards of one device.

The port of the reference's ``make_stream_mesh``, ``dp_axes`` and
``dp_size`` (``repro/launch/mesh.py``).  The reference's stream mesh is a
flat ``("data",)`` axis of devices; its multi-shard cases run on the
logical devices of one host.  Here a shard is a contiguous block of the
slot pool's rows on one device: ``StreamMesh`` holds one ``torch.device``
per shard, and the sharded kernel entry points (``kernels/ops.py``) make
one launch per shard on its rows, with the weights shared, as the
reference's ``shard_map`` makes one per device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["StreamMesh", "make_stream_mesh", "dp_axes", "dp_size"]


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """A 1-D data-parallel mesh: ``devices[s]`` holds shard ``s``'s rows.

    Every shard of a mesh that :func:`make_stream_mesh` makes lies on one
    device; a mesh over several distinct devices can be built, but nothing
    runs on it yet (``device`` raises)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        """Shards per axis, as the reference's mesh reports them."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on; ``NotImplementedError``
        when the shards name more than one."""
        distinct = set(self.devices)
        if len(distinct) != 1:
            raise NotImplementedError(
                f"a mesh over the devices {sorted(map(str, distinct))} is "
                "not supported yet: ROADMAP queue item A.9b, multi-card "
                "slot pool")
        return self.devices[0]


def canonical_device(device) -> torch.device:
    """``device`` with the index a CUDA tensor made on it would report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_stream_mesh(n_shards: int, device="cuda") -> StreamMesh:
    """S logical shards of one device.  ``device="cuda"`` raises when no
    card is present, as the scheduler does; pass ``device="cpu"`` to run
    the kernels' plain versions."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_stream_mesh(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return StreamMesh((canonical_device(device),) * n_shards)


def dp_axes(mesh: StreamMesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_size(mesh: StreamMesh) -> int:
    """Shards along the data-parallel axes: S."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))
