"""Generic async execution plane: double buffering + epoch barriers.

The port of the reference's ``repro/runtime/async_plane.py``.  Every
async workload on the slot pool follows one discipline:

  * **double-buffered dispatch** — enqueue step N+1 on the device while
    step N still runs (each device's CUDA stream orders them) and run step N's
    host-side fold at its *retirement*, when N+1 is already executing, so
    host work hides under device compute;
  * **deferred FIFO fold** — retirements apply results strictly in
    dispatch order, keeping every per-slot sequence bit-identical to the
    synchronous schedule;
  * **epoch barriers** — any structural pool operation (resize,
    rebalance, priming, teardown) first drains every in-flight step, so a
    slot remap can never invalidate in-flight row indices.

:class:`InFlightQueue` packages that protocol: workloads push opaque
in-flight records with a retire function, and the queue owns the depth
policy, the FIFO drain and the barrier.  Wiring ``queue.barrier`` as the
pool's ``pre_structural`` hook makes barriers *declared*: the pool calls
it before every structural mutation, on every path.

:class:`IngestPump` is the host-ingest half of the same plane — a daemon
worker that lands queued pushes through a workload-supplied apply
function (which must take the workload's ingest lock), with deferred
error surfacing at ``flush``.  Its ``flush`` and ``close`` take a
timeout and raise ``TimeoutError`` when it runs out.

Pipeline depth is 1 by default (classic double buffering); deeper
pipelines only add queue latency before the fold without increasing
overlap, since one step's compute already hides the next step's host
work.
"""
from __future__ import annotations

import queue
import threading

__all__ = ["InFlightQueue", "IngestPump"]

_SENTINEL = object()


class InFlightQueue:
    """FIFO of dispatched-but-unretired steps with a declared depth.

    ``retire_fn(item, still_in_flight)`` fences on the item's device work
    and applies its deferred fold; ``still_in_flight`` tells the fold
    whether a later step is executing underneath it (its host work is
    then hidden under device compute).  The retire policy is the
    double-buffered contract: retire once the queue is past its depth, or
    when the workload is starved (nothing newly dispatched) and work
    remains to drain.
    """

    def __init__(self, retire_fn, depth: int = 1) -> None:
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self._retire = retire_fn
        self.depth = depth
        self._items: list = []

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def push(self, item) -> None:
        self._items.append(item)

    def retire_oldest(self):
        """Fence + fold the oldest in-flight step (FIFO)."""
        item = self._items.pop(0)
        return self._retire(item, bool(self._items))

    def settle(self, dispatched: bool, max_retire: int | None = 1) -> list:
        """Apply the depth policy for one pipeline turn: retire while the
        queue is past its depth, or — when nothing was dispatched — while
        anything is in flight.  ``max_retire`` bounds the retirements per
        turn (``None`` = drain to policy); returns the retired results in
        dispatch order."""
        out: list = []
        while self._items and (len(self._items) > self.depth
                               or not dispatched):
            out.append(self.retire_oldest())
            if max_retire is not None and len(out) >= max_retire:
                break
        return out

    def barrier(self) -> list:
        """Epoch barrier: retire EVERY in-flight step.  Callers then hold
        the invariant a synchronous workload has between steps — all
        folds applied, no in-flight step references any slot row — so
        structural remaps run exactly as they do synchronously."""
        out: list = []
        while self._items:
            out.append(self.retire_oldest())
        return out


class IngestPump:
    """Background ingest worker: queued ``(sids, chunks)`` batches land
    in the arena from a daemon thread via ``apply_fn`` (which must take
    the scheduler's ingest lock).  ``submit`` never blocks on the device;
    ``flush`` waits until every queued push has landed and re-raises the
    first error a push hit (unknown sid, arena overflow — all raised
    *before* any sample lands, so a failed push never half-applies)."""

    def __init__(self, apply_fn) -> None:
        self._apply = apply_fn
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._done = threading.Condition()
        self._pending = 0  # submitted, not yet applied (under _done)
        self._err: Exception | None = None
        self.pushed_batches = 0
        self._thread = threading.Thread(
            target=self._run, name="ingest-pump", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                sids, chunks = item
                try:
                    self._apply(sids, chunks)
                    self.pushed_batches += 1
                except Exception as e:  # surfaced at the next flush
                    if self._err is None:
                        self._err = e
            finally:
                with self._done:
                    self._pending -= 1
                    self._done.notify_all()

    def _put(self, item) -> None:
        with self._done:
            self._pending += 1
        self._q.put(item)

    def submit(self, sids, chunks) -> None:
        self._put((list(sids), list(chunks)))

    def _wait(self, timeout: float | None) -> None:
        with self._done:
            if not self._done.wait_for(lambda: self._pending == 0,
                                       timeout):
                raise TimeoutError(
                    f"ingest pump: {self._pending} push batch(es) still "
                    f"queued after {timeout} s")

    def _raise_deferred(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def flush(self, timeout: float | None = None) -> None:
        """Barrier: every push submitted before this call has landed (or
        failed).  Raises the first deferred push error, once, and
        ``TimeoutError`` when pushes are still queued after ``timeout``
        seconds."""
        self._wait(timeout)
        self._raise_deferred()

    def close(self, timeout: float | None = None) -> None:
        """Flush, then stop the worker thread (errors still surface);
        ``TimeoutError`` when either takes longer than ``timeout``."""
        self._put(_SENTINEL)
        self._wait(timeout)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"ingest pump thread still alive after {timeout} s")
        self._raise_deferred()
