"""Keyword-detection event logic on per-frame streaming logits.

The model emits raw popcount-count logits once per hop.  A deployed KWS
front door never acts on a single frame: posteriors are smoothed over a
short window, a keyword fires only when the smoothed posterior crosses an
*on* threshold, and the detector then holds (refractory) until both the
posterior has fallen below a lower *off* threshold and a minimum number of
frames has elapsed — classic hysteresis, so one utterance produces exactly
one event instead of a burst.

Two implementations share the exact same semantics:

* ``PosteriorDetector`` — one python state machine per stream.  ``update``
  takes raw logits and softmaxes them on the host; ``update_posterior``
  consumes posteriors already computed on-device.  Kept as the oracle and
  for standalone use.
* ``BatchedDetector`` — the whole fleet's detector state as slot-indexed
  numpy vectors (struct-of-arrays, like ``state.RingArena``): smoothing
  windows, hold flags, refractory clocks.  One ``update_batch`` call
  advances every ready slot with array ops; per-slot python survives only
  for rows that actually fire (rare by construction).  This is what the
  scheduler drives on the hop hot path; equivalence with the per-stream
  machine is pinned by tests/test_ingest.py.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.stream.state import remap_rows


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    smooth_frames: int = 4        # moving-average window over posteriors
    on_threshold: float = 0.6     # smoothed posterior to fire
    off_threshold: float = 0.4    # smoothed posterior to re-arm
    refractory_frames: int = 10   # min frames between events
    keyword_classes: tuple[int, ...] = tuple(range(10))  # 10/11 = unk/sil


@dataclasses.dataclass(frozen=True)
class Detection:
    stream_id: int
    cls: int
    frame: int      # final-conv frame index at which the event fired
    score: float    # smoothed posterior at fire time


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits.astype(np.float64) - logits.max()
    e = np.exp(z)
    return e / e.sum()


class PosteriorDetector:
    """Per-stream smoothing + hysteresis/refractory state machine."""

    def __init__(self, stream_id: int, cfg: DetectorConfig | None = None) -> None:
        self.stream_id = stream_id
        self.cfg = cfg or DetectorConfig()
        self._window: collections.deque[np.ndarray] = collections.deque(
            maxlen=self.cfg.smooth_frames
        )
        self._holding = False
        self._hold_cls = -1
        self._fired_at = -(10**9)
        self.events: list[Detection] = []

    def smoothed(self) -> np.ndarray:
        assert self._window, "no frames seen yet"
        return np.mean(np.stack(self._window), axis=0)

    def update(self, frame: int, logits: np.ndarray) -> Detection | None:
        """Feed one frame of raw logits (host-side softmax); returns a
        Detection iff one fires."""
        return self.update_posterior(frame, _softmax(np.asarray(logits)))

    def update_posterior(self, frame: int,
                         posterior: np.ndarray) -> Detection | None:
        """Feed one frame of already-normalized posteriors (e.g. the
        on-device softmax from the scheduler's finalization tail)."""
        cfg = self.cfg
        self._window.append(np.asarray(posterior, np.float64))
        if len(self._window) < cfg.smooth_frames:
            # a partial window would let one confident-wrong frame (common
            # right after priming, when the field is mostly padding) bypass
            # the glitch suppression the smoother exists for
            return None
        post = self.smoothed()
        kw = np.asarray(cfg.keyword_classes)
        best = int(kw[np.argmax(post[kw])])
        score = float(post[best])

        if self._holding:
            # re-arm only after the held keyword decays AND refractory passes
            held = float(post[self._hold_cls])
            if (held <= cfg.off_threshold
                    and frame - self._fired_at >= cfg.refractory_frames):
                self._holding = False
            return None

        if score >= cfg.on_threshold:
            self._holding = True
            self._hold_cls = best
            self._fired_at = frame
            det = Detection(self.stream_id, best, frame, score)
            self.events.append(det)
            return det
        return None


_NEVER = -(10**9)  # "fired long ago": refractory never blocks the first event


class BatchedDetector:
    """Slot-vectorized smoothing + hysteresis for the whole slot pool.

    State per slot: a ring of the last ``smooth_frames`` posteriors (kept
    in arrival order at read time so the float64 mean accumulates in the
    same order as the per-stream deque — bit-identical smoothing), the
    hold flag/class, and the last fire frame.  ``update_batch`` advances
    many slots with pure array ops and returns only the rows that fired;
    ``apply_remap`` follows ``SlotPlacement`` through elastic resizes like
    every other slot-indexed array.
    """

    def __init__(self, capacity: int, n_classes: int,
                 cfg: DetectorConfig | None = None) -> None:
        self.cfg = cfg or DetectorConfig()
        self.n_classes = n_classes
        self._kw = np.asarray(self.cfg.keyword_classes, np.int64)
        W = self.cfg.smooth_frames
        self._win = np.zeros((capacity, W, n_classes), np.float64)
        self._count = np.zeros(capacity, np.int64)
        self._holding = np.zeros(capacity, bool)
        self._hold_cls = np.zeros(capacity, np.int64)
        self._fired_at = np.full(capacity, _NEVER, np.int64)

    @property
    def capacity(self) -> int:
        return self._count.shape[0]

    def reset_slot(self, slot: int) -> None:
        """Scrub one slot for its next tenant."""
        self._win[slot] = 0.0
        self._count[slot] = 0
        self._holding[slot] = False
        self._hold_cls[slot] = 0
        self._fired_at[slot] = _NEVER

    def state_digest(self, slot: int) -> tuple:
        """One slot's full hysteresis state as hashable plain values —
        the concurrency suite's equality probe: after any interleaving,
        the async scheduler's detector must hold bit-identical state to
        the synchronous one (deferred folds retire in FIFO dispatch
        order, so each slot sees the same posterior sequence)."""
        return (
            self._win[slot].tobytes(),
            int(self._count[slot]),
            bool(self._holding[slot]),
            int(self._hold_cls[slot]),
            int(self._fired_at[slot]),
        )

    def apply_remap(self, remap: dict[int, int], new_capacity: int) -> None:
        self._win = remap_rows(self._win, remap, new_capacity)
        self._count = remap_rows(self._count, remap, new_capacity)
        self._holding = remap_rows(self._holding, remap, new_capacity)
        self._hold_cls = remap_rows(self._hold_cls, remap, new_capacity)
        self._fired_at = remap_rows(self._fired_at, remap, new_capacity,
                                    fill=_NEVER)

    def update_batch(self, slots: np.ndarray, frames: np.ndarray,
                     posteriors: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Feed one posterior frame to each of ``slots``; returns
        ``(rows, cls, score)`` — indices INTO ``slots`` that fired, with
        the detected class and smoothed score.  No python loop over slots.
        """
        cfg = self.cfg
        W = cfg.smooth_frames
        slots = np.asarray(slots, np.int64)
        frames = np.asarray(frames, np.int64)
        self._win[slots, self._count[slots] % W] = posteriors
        self._count[slots] += 1
        count = self._count[slots]
        full = count >= W
        # gather each slot's window in ARRIVAL order (oldest first) so the
        # float64 mean sums in the same order as PosteriorDetector's deque
        order = (count[:, None] + np.arange(W)[None, :]) % W
        post = self._win[slots[:, None], order].mean(axis=1)
        r = np.arange(slots.size)
        best = self._kw[np.argmax(post[:, self._kw], axis=1)]
        score = post[r, best]
        holding = self._holding[slots].copy()
        # holding rows re-arm only after the held keyword decays AND the
        # refractory passes; a row released this frame cannot also fire
        held = post[r, self._hold_cls[slots]]
        release = holding & full & (held <= cfg.off_threshold) & (
            frames - self._fired_at[slots] >= cfg.refractory_frames
        )
        self._holding[slots[release]] = False
        fire = full & ~holding & (score >= cfg.on_threshold)
        rows = np.nonzero(fire)[0]
        self._holding[slots[rows]] = True
        self._hold_cls[slots[rows]] = best[rows]
        self._fired_at[slots[rows]] = frames[rows]
        return rows, best[rows], score[rows]
