"""Meshes: the production and host ``DeviceMesh``es, and the stream slot
pool's S logical shards of one device.

The port of the reference's ``repro/launch/mesh.py``.

Production meshes keep the reference's logical shapes, read as H100s:
``(16, 16)`` with axes ``("data", "model")`` (256 cards) and ``(2, 16,
16)`` with ``("pod", "data", "model")`` (512 cards).  One process builds
them over a *fake* process group of that many ranks (``fake_world``): no
collective moves data, which is what the dry run
(``launch/dryrun.py``) needs to run the step on DTensors of fake tensors
and read its per-device shapes, costs and collectives.
``make_host_mesh`` spans the real cards of the machine.

The stream mesh is the port of ``make_stream_mesh``, ``dp_axes`` and
``dp_size``.  The reference's stream mesh is a
flat ``("data",)`` axis of devices; its multi-shard cases run on the
logical devices of one host.  Here a shard is a contiguous block of the
slot pool's rows on one device: ``StreamMesh`` holds one ``torch.device``
per shard, and the sharded kernel entry points (``kernels/ops.py``) make
one launch per shard on its rows, with the weights shared, as the
reference's ``shard_map`` makes one per device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

__all__ = ["StreamMesh", "dp_axes", "dp_size", "fake_world",
           "make_host_mesh", "make_mesh", "make_production_mesh",
           "make_stream_mesh"]


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process (rank 0) for
    the block, destroyed after it.  Collectives on it move nothing.  Only
    one default group can exist in a process: entering with one already
    started raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already started")
    # importing this module registers the "fake" backend's constructor
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(device_type: str, shape, axes):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    started process group, which must hold exactly that many ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a {shape} mesh needs a started process group of {n} ranks "
            "(fake_world(n) for the dry run)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """One pod: (16, 16) over ("data", "model"); ``multi_pod``: (2, 16,
    16) over ("pod", "data", "model").  Needs a started group of 256 or
    512 ranks (``fake_world``); ``device_type`` is that of the tensors
    the mesh will hold."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(device_type, shape, axes)


def make_host_mesh(model_parallel: int = 1, device_type="cuda"):
    """A (n / model_parallel, model_parallel) ("data", "model") mesh over
    the n cards of this machine (the CPU counts as one device).  With one
    card and no group started, starts a one-rank group (``gloo``, which
    carries CUDA tensors too); with more, the caller runs one process per
    card and starts the group."""
    import torch.distributed as dist

    n = torch.cuda.device_count() if device_type == "cuda" else 1
    if n == 0:
        raise RuntimeError("make_host_mesh(device_type='cuda') needs a "
                           "CUDA device and none is available")
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel="
                         f"{model_parallel}")
    if n == 1 and not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh(device_type, (n // model_parallel, model_parallel),
                        ("data", "model"))


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
