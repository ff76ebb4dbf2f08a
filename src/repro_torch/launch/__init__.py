"""Launch tools of the port: ``mesh`` (the production, host and stream
meshes, and the fake process group the dry run runs in), the LM
launchers ``serve`` and ``train``, and the dry run's tools ``dryrun``,
``roofline``, ``hillclimb`` and ``report`` (each ``python -m
repro_torch.launch.<name>``)."""
from repro_torch.launch.mesh import (
    StreamMesh,
    dp_axes,
    dp_size,
    make_stream_mesh,
)

__all__ = ["StreamMesh", "dp_axes", "dp_size", "make_stream_mesh"]
