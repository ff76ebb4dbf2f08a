"""Launch accounting for the port's hand-written kernels.

Every kernel wrapper calls :func:`record` with its kernel's name at the one
place where it launches the kernel (on the CPU, where its plain PyTorch
version stands in for the kernel, at the one place it calls that), so the
counters say how many times each kernel ran.  This is the port's
counterpart of the reference's trace-time ``pallas_call`` counter: PyTorch
runs eagerly, so the count is taken per call rather than per trace, and
``_BatchedModel.dispatches_per_hop`` is checked against it per hop.

The counters are plain module-level integers (no locks, no thread-locals):
a reader resets them with :func:`reset` just before the work it measures
and reads :func:`counts` just after, or wraps the work in
:func:`counting`.
"""
from __future__ import annotations

import collections
import contextlib

_counts: collections.Counter = collections.Counter()


def record(name: str) -> None:
    """Count one launch of the kernel ``name``."""
    _counts[name] += 1


def count(name: str | None = None) -> int:
    """Launches of ``name`` (of every kernel when None) since the last
    :func:`reset`."""
    if name is None:
        return sum(_counts.values())
    return _counts[name]


def counts() -> dict[str, int]:
    """Launches per kernel name since the last :func:`reset`."""
    return dict(_counts)


def reset() -> None:
    """Set every counter to 0."""
    _counts.clear()


@contextlib.contextmanager
def counting():
    """Yield a zero-arg callable returning the launches per kernel name
    made since entry (the counters themselves are not reset)."""
    start = collections.Counter(_counts)
    yield lambda: {k: v - start[k] for k, v in _counts.items()
                   if v - start[k]}
