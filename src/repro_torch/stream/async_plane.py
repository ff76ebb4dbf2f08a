"""The async execution plane is not ported yet (ROADMAP queue item A.7).

The reference's ``repro.stream.async_plane.AsyncStreamScheduler`` overlaps
ingest, pack and device compute with double-buffered hop dispatch and
donated state buffers.  Its port (CUDA streams and events in place of
XLA's async dispatch, in-place state buffers in place of donation) comes
with A.7; until then the name exists and refuses to construct, so a caller
learns why instead of getting an ``ImportError``.
"""
from __future__ import annotations


class AsyncStreamScheduler:
    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "AsyncStreamScheduler is not ported yet: ROADMAP queue item A.7"
        )
