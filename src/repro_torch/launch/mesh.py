"""Meshes: the production and host ``DeviceMesh``es, and the stream slot
pool's mesh of shards over one device or several.

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
``dp_size``: a flat ``("data",)`` axis of S shards.  ``StreamMesh`` holds
one ``torch.device`` per shard, and a slot pool over S >= 2 shards keeps
shard ``s``'s rows of every batched tensor in a tensor of their own on
``devices[s]`` (:class:`ShardRows`), whether the shards share one device
or each has a card: the scheduler makes one launch of each kernel per
shard on its rows, with a copy of the weights on each distinct device,
as the reference's ``shard_map`` makes one per device.  A value every
shard reads alike (the LM engine's shared position clock) is a
:class:`Replicated`: one copy on each distinct device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

__all__ = ["Replicated", "ShardRows", "StreamMesh", "canonical_device",
           "current", "dp_axes", "dp_size", "fake_world", "make_host_mesh",
           "make_mesh", "make_production_mesh", "make_stream_mesh"]


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


def canonical_device(device) -> torch.device:
    """``device`` with the index a CUDA tensor made on it would report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def current(device: torch.device):
    """A context with ``device`` current (nothing to set for the CPU):
    a shard's ops on a card other than the current one then switch no
    device each."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """A 1-D data-parallel mesh: ``devices[s]`` holds shard ``s``'s rows.

    The shards may share one device (S logical shards of a card or of the
    CPU) or lie on several cards; every device is of one type, as no JAX
    mesh mixes platforms (``ValueError`` otherwise)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self) -> None:
        devices = tuple(canonical_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        if len({d.type for d in devices}) != 1:
            raise ValueError(
                "a mesh mixes device types "
                f"{sorted({d.type for d in devices})}: every shard must lie "
                "on the same kind of device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict[str, int]:
        """Shards per axis, as the reference's mesh reports them."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The devices the shards lie on, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on; ``ValueError`` for a mesh
        over several."""
        if len(self.distinct) != 1:
            raise ValueError(
                f"a mesh over the devices {[str(d) for d in self.distinct]}"
                " has no single device")
        return self.devices[0]

    def zeros(self, shape, dtype=torch.int32) -> ShardRows:
        """A zero :class:`ShardRows` of ``shape`` (rows first, a multiple
        of the shards)."""
        rows = _shard_rows(shape[0], len(self.devices))
        return ShardRows(torch.zeros((rows, *shape[1:]), dtype=dtype,
                                     device=d) for d in self.devices)

    def split(self, x) -> ShardRows:
        """A host array or tensor's rows as a :class:`ShardRows`, each
        shard's block copied to its device."""
        x = torch.as_tensor(x)
        rows = _shard_rows(x.shape[0], len(self.devices))
        return ShardRows(x[s * rows:(s + 1) * rows].to(d, copy=True)
                         for s, d in enumerate(self.devices))


def _shard_rows(b: int, n_shards: int) -> int:
    if b % n_shards:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{n_shards} shards")
    return b // n_shards


class ShardRows:
    """One batched tensor of a slot pool over S shards: ``parts[s]`` is
    shard ``s``'s block of rows, a tensor of its own on the mesh's
    ``devices[s]``.  Row ``r`` of the pool is row ``r % n`` of
    ``parts[r // n]`` (``n`` rows a shard).  The slot pool, the kernels'
    launches and the scheduler's glue act on each part on its device; only
    :meth:`cpu` brings the rows together, in pool order."""

    __slots__ = ("parts",)

    def __init__(self, parts) -> None:
        self.parts = tuple(parts)

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size((len(self.parts) * p.shape[0], *p.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    def locate(self, row: int) -> tuple[int, int]:
        """``(shard, row within the shard)`` of pool row ``row``."""
        return divmod(int(row), self.parts[0].shape[0])

    def map(self, fn) -> ShardRows:
        """``fn`` on each shard's part, on its device."""
        return ShardRows(fn(p) for p in self.parts)

    def cpu(self) -> torch.Tensor:
        """Every shard's rows on the host, in pool order: one copy per
        distinct device (the parts of the shards it holds, joined there
        first)."""
        by_device: dict = {}
        for s, p in enumerate(self.parts):
            by_device.setdefault(p.device, []).append(s)
        host = list(self.parts)
        for shards in by_device.values():
            parts = [self.parts[s] for s in shards]
            joined = (torch.cat(parts) if len(parts) > 1 else parts[0]).cpu()
            for s, h in zip(shards, joined.split(
                    [p.shape[0] for p in parts])):
                host[s] = h
        return torch.cat(host)

    def put_rows(self, rows, values) -> None:
        """``pool[rows] = values`` for host ``rows`` and ``values``, each
        shard's share written on its device."""
        rows = np.asarray(rows, np.int64)
        values = torch.as_tensor(np.asarray(values))
        n = self.parts[0].shape[0]
        for s, p in enumerate(self.parts):
            sel = np.nonzero(rows // n == s)[0]
            if sel.size:
                p[torch.as_tensor(rows[sel] % n, device=p.device)] = \
                    values[torch.as_tensor(sel)].to(p.device, p.dtype)

    def __repr__(self) -> str:
        return (f"ShardRows({len(self.parts)} x {tuple(self.parts[0].shape)}"
                f", {[str(d) for d in self.devices]})")


class Replicated:
    """One value of a pool over S shards that every shard reads alike:
    ``copies[d]`` holds it on each distinct device ``d`` of the mesh, in
    the mesh's order.  ``int()`` reads the first copy."""

    __slots__ = ("copies",)

    def __init__(self, copies: dict) -> None:
        self.copies = dict(copies)

    def on(self, device) -> torch.Tensor:
        return self.copies[canonical_device(device)]

    def map(self, fn) -> Replicated:
        """``fn`` on each device's copy, on its device."""
        return Replicated({d: fn(t) for d, t in self.copies.items()})

    def __int__(self) -> int:
        return int(next(iter(self.copies.values())))

    def __repr__(self) -> str:
        return f"Replicated({[str(d) for d in self.copies]})"


def make_stream_mesh(n_shards: int | None = None, device="cuda", *,
                     cards: int | None = None) -> StreamMesh:
    """The slot pool's mesh.

    * ``device="cpu"`` or an indexed card (``"cuda:1"``): ``n_shards``
      (default 1) logical shards of that one device; the CPU runs the
      kernels' plain versions.
    * ``device="cuda"``: the first ``cards`` cards, all visible cards by
      default, as the reference's mesh spans every visible device;
      ``n_shards`` (default one a card) must be a multiple of them, and
      each card holds ``n_shards / cards`` contiguous shards.  More cards
      than are visible raise ``ValueError``.

    A ``cuda`` device raises ``RuntimeError`` when no card is present, as
    the scheduler does."""
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_stream_mesh(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain versions")
    if device.type == "cpu" or device.index is not None:
        if cards is not None:
            raise ValueError(f"cards={cards} with the one device {device}: "
                             "pass device='cuda' for a mesh over cards")
        devices = [device]
    else:
        visible = torch.cuda.device_count()
        n = visible if cards is None else cards
        if not 1 <= n <= visible:
            raise ValueError(f"a mesh over {n} cards, and {visible} are "
                             "visible (CUDA_VISIBLE_DEVICES sets which)")
        devices = [torch.device("cuda", i) for i in range(n)]
    n_shards = len(devices) if n_shards is None else n_shards
    if n_shards % len(devices):
        raise ValueError(f"{n_shards} shards do not split evenly over "
                         f"{len(devices)} cards")
    per = n_shards // len(devices)
    return StreamMesh(tuple(d for d in devices for _ in range(per)))


def dp_axes(mesh: StreamMesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_size(mesh: StreamMesh) -> int:
    """Shards along the data-parallel axes: S."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))
