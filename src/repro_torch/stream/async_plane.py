"""Async execution plane: overlap ingest, pack, and device compute.

The port of the reference's ``repro/stream/async_plane.py``.  The
synchronous ``StreamScheduler.step_batch`` is strictly serial — push ->
pack -> dispatch -> fence -> fold — so the host's pack, dispatch and
detector work sit on the critical path beside the hop kernel.  This
module is the runtime-level twin of the paper's flexible ping-pong
feature SRAM (§II-C): stage the next tile while the current one computes.

``AsyncStreamScheduler`` keeps the scheduler's math, state, and slot
machinery identical and changes only *when* the host-side stages run:

  * **Ingest pump** — ``push_audio_batch`` enqueues to a daemon thread
    that lands samples in the shared ``RingArena`` while the main thread
    packs and dispatches.  Arena mutations are serialized by the
    scheduler's ingest lock and marked by the arena's seqlock generation,
    so lock-free observers can detect (and retry past) a torn read.
  * **Double-buffered hop dispatch** — pack hop N+1 and enqueue it while
    hop N still runs: the scheduler stages every operand and result
    through pinned host buffers with ``non_blocking`` copies on the
    kernels' CUDA stream of each device, so a dispatch never waits on
    the device, and each device's stream orders hop N+1 after hop N.  With ``donate_buffers``
    (default on) the megakernel writes each hop's state into the second
    resident state set, the two swapping every hop.  The fence (the hop's
    CUDA events, one per device of a mesh) and fold for hop N run at its
    *retirement*, when hop N+1
    is already executing — the pack, detector and metrics work hide under
    device compute.
  * **Deferred FIFO fold** — retirements apply detector/metrics/event
    results strictly in dispatch order, so every slot sees the exact
    posterior sequence the synchronous schedule would produce:
    detections, hysteresis state, frame counts and the event log's
    per-stream lifecycle are bit-identical (tests/test_torch_async.py).
  * **Epoch barriers** — elastic resize, rebalance, mass-join priming,
    ``register_model``, ``peek`` and ``close_stream`` first retire every
    in-flight hop, then remap/prime exactly as the synchronous path
    would, then let the pipeline refill; a remap can never invalidate an
    in-flight hop's row indices.

Pipeline depth is 1 by default (classic double buffering); deeper
pipelines only add queue latency before the fold without increasing
overlap, since one hop's compute already hides the next hop's host work.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.runtime.async_plane import InFlightQueue, IngestPump
from repro_torch.stream.detector import Detection
from repro_torch.stream.scheduler import (
    HopBatch,
    StreamResult,
    StreamScheduler,
    _Dispatched,
)

__all__ = ["AsyncStreamScheduler", "IngestPump"]


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unretired hop: the host-side inputs its
    deferred fold needs (``shard_counts``: the ready streams of each
    shard, counted at pack time, before any later migration), plus the
    dispatched results to fence on."""

    ready_slots: np.ndarray
    shard_counts: np.ndarray
    hop: _Dispatched
    t0: float
    t_pack: float
    t_dispatch: float
    hidden_s: float           # pack+dispatch wall already under device


class AsyncStreamScheduler(StreamScheduler):
    """``StreamScheduler`` with the async execution plane switched on.

    Drop-in: the constructor, ``push_audio*``, ``step``/``step_batch``,
    ``drain``, ``peek``, ``close_stream`` signatures are unchanged and the
    results are bit-identical to the synchronous scheduler for any
    interleaving of calls.  Extra keywords: ``pipeline_depth`` (hops in
    flight, default 1), ``use_pump`` (land pushes from a worker thread,
    default True); ``donate_buffers`` defaults to True.  ``mesh`` passes
    through: over S shards a hop dispatches its launches once per shard,
    and a cross-shard rebalance, like a resize, runs behind an epoch
    barrier.  The differences are operational:

      * ``push_audio_batch`` returns before samples land (the pump
        applies them; push errors surface at the next ``flush_ingest``/
        ``drain``/``peek``/``close_stream``);
      * ``step_batch`` may return ``None`` for a hop it *dispatched*
        (still in flight) and returns hop N's results while hop N+1
        executes — results arrive one call later than the sync path, in
        the same order;
      * ``drain()`` is the safe settling point: pump flushed, every
        in-flight hop retired.

    Call ``shutdown()`` when discarding the scheduler: it settles the
    pipeline and stops the pump thread.
    """

    def __init__(self, *args, pipeline_depth: int = 1,
                 use_pump: bool = True, **kwargs) -> None:
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        kwargs.setdefault("donate_buffers", True)
        # sizes the host staging ring the base constructor makes
        self._pipeline_depth = pipeline_depth
        super().__init__(*args, **kwargs)
        self._inflight = InFlightQueue(self._retire_inflight,
                                       depth=pipeline_depth)
        self._dispatched_total = 0
        # serializes arena/placement/bookkeeping mutations between the
        # main thread (pack/fold/lifecycle) and the pump (push scatter);
        # the device queue itself needs no lock — only the main thread
        # dispatches
        self._lock = threading.RLock()
        # declare the epoch barrier to the slot pool: EVERY structural
        # mutation (grow-on-alloc, shrink-on-close, rebalance) drains the
        # pipeline first, on every path
        self._slots.pre_structural = self._pre_structural
        self._pump = IngestPump(self._apply_push) if use_pump else None

    # -- ingest (pumped) -----------------------------------------------------

    def _apply_push(self, sids, chunks) -> None:
        with self._lock:
            StreamScheduler.push_audio_batch(self, sids, chunks)

    def push_audio_batch(self, sids, chunks) -> None:
        if self._pump is None:
            self._apply_push(sids, chunks)
        else:
            self._pump.submit(sids, chunks)

    def push_audio(self, sid: int, audio: np.ndarray) -> None:
        # the scalar push rides the pump too (one-element batch: same
        # arena counters, same quantize math)
        self.push_audio_batch([sid], [audio])

    def flush_ingest(self, timeout: float | None = None) -> None:
        """Wait until every submitted push has landed in the arena;
        ``TimeoutError`` after ``timeout`` seconds."""
        if self._pump is not None:
            self._pump.flush(timeout)

    # -- pipeline core -------------------------------------------------------

    @property
    def in_flight(self) -> int:
        """Dispatched hops whose fold has not retired yet."""
        return len(self._inflight)

    def _retire_inflight(self, f: _InFlight, still_in_flight: bool
                         ) -> HopBatch:
        """Retire function the ``InFlightQueue`` drives: fence on one hop
        (its event, which also covers the copies of its results) and run
        its deferred fold.  The fence runs outside the ingest lock, so
        pushes keep landing while the device finishes; the fold (detector,
        metrics, events, emit cache) runs under it, in FIFO order."""
        logits_h, post_h = self._fence(f.hop)
        t_device = self._clock()
        with self._lock:
            return self._fold_hop(
                f.ready_slots, f.shard_counts, logits_h, post_h,
                f.t0, f.t_pack, f.t_dispatch, t_device,
                hidden_s=f.hidden_s, fold_hidden=still_in_flight,
                dispatches=f.hop.dispatches,
            )

    def _epoch_barrier(self) -> None:
        """Retire every in-flight hop.  Callers then hold the invariant
        the synchronous scheduler has between steps — all folds applied,
        no in-flight hop references any slot row — so resize / rebalance /
        priming / teardown run exactly as they do synchronously."""
        self._inflight.barrier()

    def _pre_structural(self) -> None:
        """SlotPool hook: a structural slot mutation is about to run —
        drain the pipeline first (the epoch barrier, declared once)."""
        with self._lock:
            self._epoch_barrier()

    def _advance(self) -> tuple[bool, HopBatch | None]:
        """One pipeline turn: dispatch a hop if any stream is ready, and
        retire the oldest in-flight hop once the pipeline is past its
        depth (or when starved).  Returns ``(dispatched, retired)``."""
        with self._lock:
            if self._slots.skew_dirty or self._unprimed:
                # epoch barrier: drain the pipeline, then rebalance /
                # shrink / prime at the same logical point the sync
                # scheduler would
                self._epoch_barrier()
                self._hop_barriers()
            packed = self._pack_ready()
            if packed is not None:
                (ready_slots, ready_mask, audio, shard_counts,
                 t0, t_pack) = packed
                was_busy = bool(self._inflight)
                hop = self._dispatch_hop(ready_mask, audio)
                t_dispatch = self._clock()
                self._inflight.push(_InFlight(
                    ready_slots=ready_slots, shard_counts=shard_counts,
                    hop=hop, t0=t0, t_pack=t_pack, t_dispatch=t_dispatch,
                    # this hop's pack+dispatch ran while an earlier hop
                    # was executing: that host wall is hidden
                    hidden_s=(t_dispatch - t0) if was_busy else 0.0,
                ))
                self._dispatched_total += 1
            else:
                self._slots.maybe_prewarm()  # starved turn: warm the grow
        dispatched = packed is not None
        # depth policy (retire at most one per turn): retire once the
        # pipeline is past its depth, or when starved and hops remain
        retired = self._inflight.settle(dispatched, max_retire=1)
        return dispatched, (retired[0] if retired else None)

    # -- public stepping -----------------------------------------------------

    def step_batch(self) -> HopBatch | None:
        """One pipeline turn.  Unlike the sync scheduler, ``None`` can
        mean "hop dispatched, results not retired yet" — callers that
        need everything settled use ``drain()`` (or ``peek``/
        ``close_stream``, which barrier internally)."""
        return self._advance()[1]

    def run_until_starved(self):
        """Step until no stream has a full hop buffered AND every
        dispatched hop has retired; returns the collated tuples."""
        self.flush_ingest()
        out = []
        while True:
            dispatched, retired = self._advance()
            if retired is not None:
                out.extend(self._collate(retired))
            if not dispatched and not self._inflight:
                return out

    def drain(self) -> int:
        """Flush the pump, run the pipeline until starved, and retire
        every in-flight hop; returns hops *dispatched* by this call
        (== hops the sync scheduler would have executed)."""
        self.flush_ingest()
        before = self._dispatched_total
        while True:
            dispatched, _ = self._advance()
            if not dispatched and not self._inflight:
                return self._dispatched_total - before

    # -- epoch-barrier lifecycle overrides -----------------------------------
    #
    # resize and rebalance need NO overrides here: the SlotPool calls
    # ``_pre_structural`` (declared in __init__) before every structural
    # mutation, whichever path reaches it.

    def add_stream(self, *args, **kwargs) -> int:
        with self._lock:  # placement/arena bookkeeping vs pump pushes
            return super().add_stream(*args, **kwargs)

    def register_model(self, *args, **kwargs) -> int:
        with self._lock:
            # pool swap = epoch barrier: an in-flight hop still reads the
            # weight row an admission may overwrite (LRU eviction)
            self._epoch_barrier()
            return super().register_model(*args, **kwargs)

    def peek(self, sid: int) -> np.ndarray:
        self.flush_ingest()  # the contract covers "audio pushed so far"
        with self._lock:
            self._epoch_barrier()
            return super().peek(sid)

    def close_stream(self, sid: int) -> StreamResult:
        self.flush_ingest()  # pending pushes for this sid must land
        with self._lock:
            self._epoch_barrier()  # fold in-flight hops, then ghost-flush
            return super().close_stream(sid)

    def detections(self, sid: int) -> list[Detection]:
        """Events recorded so far for ``sid`` (settles the pipeline)."""
        with self._lock:
            self._epoch_barrier()
            return list(self._require(sid).events)

    def shutdown(self, timeout: float | None = None) -> None:
        """Settle everything and stop the pump thread (``TimeoutError``
        when the pump takes longer than ``timeout`` seconds)."""
        if self._pump is not None:
            pump, self._pump = self._pump, None
            pump.close(timeout)
        with self._lock:
            self._epoch_barrier()
