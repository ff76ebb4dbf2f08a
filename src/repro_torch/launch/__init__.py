"""Launch tools of the port: ``mesh`` (the stream slot pool's shard mesh)
and the LM launchers ``serve`` and ``train`` (``python -m
repro_torch.launch.serve`` / ``.train``).

The reference's ``repro.launch`` also holds the production and host
meshes, the dry run, the roofline and the hill climb; they are not ported
yet."""
from repro_torch.launch.mesh import (
    StreamMesh,
    dp_axes,
    dp_size,
    make_stream_mesh,
)

__all__ = ["StreamMesh", "dp_axes", "dp_size", "make_stream_mesh"]
