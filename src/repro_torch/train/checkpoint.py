"""Fault-tolerant checkpointing: atomic, versioned, integrity-checked.

Format (the standard library and torch only): one zlib stream file
per step (stored at ``ZLIB_LEVEL`` 0) holding ``MAGIC``, an 8-byte little-endian header length, a JSON
header ``{step, meta, structure, leaves: [{shape, dtype, crc, nbytes}]}``
and then every leaf's raw bytes in the tree's leaf order.  Leaves are
tensors of any dtype, bfloat16 included (its raw 16-bit words).  Nothing
is unpickled on restore.  The reference writes msgpack with zstd or zlib;
the port reads only its own files.

Guarantees:
  * atomic: write to <dir>/tmp-<step>, fsync, rename to <dir>/step-<n>
    — a crash mid-save never corrupts the latest checkpoint.
  * versioned: keep_last N checkpoints, GC older ones.
  * placement on restore: each leaf goes to the device of the template's
    leaf, so a job can restart on another device than it saved from; with
    ``shardings`` it comes back as a DTensor laid out on a new mesh
    (elastic re-sharding, the port of the reference's ``device_put`` of
    each leaf with a ``NamedSharding``).
  * sharded saves: a DTensor leaf is written as its full tensor, by rank
    0 of the started process group, once every rank has agreed on the
    step.
  * integrity: per-leaf crc32 verified on load (``IOError``), and the
    template's leaf count checked (``ValueError``).
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import zlib

import torch

from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_flatten, tree_unflatten

log = get_logger("checkpoint")

MAGIC = b"repro_torch-ckpt-1\n"
#: stored, not compressed: float weights and moments barely compress, and
#: level 6 runs at ~7 MB/s on random bf16 weights (an LM's 8 GB training
#: state would take ~20 min); the adler32 and per-leaf crc32 still hold
ZLIB_LEVEL = 0


def _leaf_to_bytes(x) -> tuple[dict, bytes]:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"shape": list(t.shape), "dtype": str(t.dtype).split(".")[-1],
            "crc": zlib.crc32(raw), "nbytes": len(raw)}, raw


def _leaf_from_bytes(d: dict, raw: bytes) -> torch.Tensor:
    if len(raw) != d["nbytes"] or zlib.crc32(raw) != d["crc"]:
        raise IOError("checkpoint leaf CRC mismatch (corrupt file)")
    flat = (torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw
            else torch.empty(0, dtype=torch.uint8))
    return flat.view(getattr(torch, d["dtype"])).reshape(d["shape"])


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def save(ckpt_dir: str | os.PathLike, step: int, tree,
         meta: dict | None = None, keep_last: int = 3) -> pathlib.Path:
    """Write ``tree`` (its tensors copied to the host) as step ``step``;
    ``meta`` must be JSON-serialisable.  The zlib stream is written leaf
    by leaf at ``ZLIB_LEVEL``.

    A tree with DTensor leaves is saved by every rank of the process
    group together: each DTensor is gathered to its full tensor (a
    collective), the ranks check that they save the same step
    (``ValueError`` otherwise), rank 0 writes, and the others wait for
    the file before they return its path."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    leaves, structure = tree_flatten(tree)
    final = ckpt_dir / f"step-{step:010d}"
    if any(_is_dtensor(x) for x in leaves):
        import torch.distributed as dist

        leaves = [x.full_tensor() if _is_dtensor(x) else x for x in leaves]
        steps = [None] * dist.get_world_size()
        dist.all_gather_object(steps, step)
        if len(set(steps)) != 1:
            raise ValueError(f"the ranks save different steps: {steps}")
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, leaves, structure, meta, keep_last)
        dist.barrier()
        return final
    _write(ckpt_dir, step, leaves, structure, meta, keep_last)
    return final


def _write(ckpt_dir: pathlib.Path, step: int, leaves, structure,
           meta: dict | None, keep_last: int) -> None:
    """:func:`save`'s file: header and leaves, atomically renamed."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    parts = [_leaf_to_bytes(x) for x in leaves]
    header = json.dumps({"step": step, "meta": meta or {},
                         "structure": repr(structure),
                         "leaves": [d for d, _ in parts]}).encode()
    tmp = ckpt_dir / f"tmp-{step}"
    final = ckpt_dir / f"step-{step:010d}"
    co = zlib.compressobj(ZLIB_LEVEL)
    with open(tmp, "wb") as f:
        for chunk in [MAGIC + struct.pack("<Q", len(header)) + header] + [
                raw for _, raw in parts]:
            f.write(co.compress(chunk))
        f.write(co.flush())
        f.flush()
        os.fsync(f.fileno())
        n_bytes = f.tell()
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    log.info("saved checkpoint %s (%.1f MB)", final.name, n_bytes / 1e6)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("-")[1])
                   for p in ckpt_dir.glob("step-*"))
    return steps[-1] if steps else None


def _sharding_entries(template, shardings) -> list:
    """The entry of ``shardings`` at each leaf of ``template``, in leaf
    order: ``shardings`` follows the template's dicts, lists and tuples
    down to the leaves, where each entry is a ``(DeviceMesh, placements)``
    pair or None (the leaf keeps the template leaf's device)."""
    out = []

    def walk(t, s):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], None if s is None else s[k])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, None if s is None else s[i])
        elif t is not None:
            out.append(s)

    walk(template, shardings)
    return out


def restore(ckpt_dir: str | os.PathLike, tree_template,
            step: int | None = None,
            shardings=None) -> tuple[int, object, dict]:
    """Load a checkpoint (the latest when ``step`` is None) into the
    structure of ``tree_template``, each leaf on the device of the
    template's leaf.  -> (step, tree, meta).

    ``shardings``: a tree like the template whose entry at each leaf is a
    ``(DeviceMesh, placements)`` pair, or None for a leaf that keeps the
    template's device.  A leaf with a pair comes back as a DTensor laid
    out so on that mesh, which may differ from the mesh it was saved
    from (every rank of the mesh calls ``restore``)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"step-{step:010d}"
    try:
        payload = zlib.decompress(path.read_bytes())
    except zlib.error as e:
        raise IOError(f"{path.name}: corrupt checkpoint ({e})") from e
    if not payload.startswith(MAGIC):
        raise IOError(f"{path.name}: not a checkpoint of this format")
    at = len(MAGIC) + 8
    (n_header,) = struct.unpack("<Q", payload[len(MAGIC):at])
    header = json.loads(payload[at:at + n_header])
    at += n_header
    leaves_raw = []
    for d in header["leaves"]:
        leaves_raw.append(_leaf_from_bytes(d, payload[at:at + d["nbytes"]]))
        at += d["nbytes"]
    flat_t, structure = tree_flatten(tree_template)
    if len(flat_t) != len(leaves_raw):
        raise ValueError(
            f"checkpoint has {len(leaves_raw)} leaves, template expects "
            f"{len(flat_t)} — architecture mismatch")
    if shardings is None:
        places = [None] * len(flat_t)
    else:
        places = _sharding_entries(tree_template, shardings)
    leaves = [_place(x, t, p) for x, t, p in zip(leaves_raw, flat_t,
                                                 places)]
    log.info("restored checkpoint step %d from %s", step, path.name)
    return step, tree_unflatten(structure, leaves), header["meta"]


def _place(x: torch.Tensor, template, placement):
    """One restored leaf on the template leaf's device, or laid out as a
    DTensor by its ``(DeviceMesh, placements)``."""
    if placement is not None:
        from torch.distributed.tensor import distribute_tensor

        mesh, placements = placement
        return distribute_tensor(x.to(mesh.device_type), mesh,
                                 list(placements))
    return x.to(template.device) if isinstance(template, torch.Tensor) \
        else x


def _gc(ckpt_dir: pathlib.Path, keep_last: int) -> None:
    ckpts = sorted(ckpt_dir.glob("step-*"))
    for old in ckpts[:-keep_last]:
        old.unlink()
