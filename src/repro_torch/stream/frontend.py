"""Incremental audio frontend: raw PCM chunks -> model-input frames.

The PSCNN model eats 8-bit offset-binary samples directly (the first conv
layer is the feature extractor), so the streaming frontend's job is
(1) quantization of float PCM with a fixed gain — streaming cannot use the
offline corpus's per-clip peak normalization because the clip never ends —
and (2) reassembly of arbitrary-sized network chunks into whole hops,
absorbing jitter between producer (mic/RTP packets) and consumer (the
batched scheduler step).

The storage itself lives in ``state.RingArena``: ONE shared uint8 sample
buffer for every stream slot, so the scheduler's hop hot path quantizes,
scatters and gathers all inboxes with vectorized calls instead of walking
per-stream ring objects.  ``AudioFrontend`` survives as the thin
per-stream facade over one arena row — same push/pop/peek API as the
pre-arena per-stream ring, now O(1) python objects per stream instead of
O(1) python *work per stream per hop*.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.stream.state import IN_OFFSET, RingArena, quantize_pcm

__all__ = ["IN_OFFSET", "AudioFrontend", "FrontendConfig", "quantize_pcm"]


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    gain: float = 1.0
    capacity_samples: int = 1 << 16  # jitter buffer depth


class AudioFrontend:
    """Per-stream inbox view: push float or u8 audio, pop whole hops.

    ``push`` accepts either u8 offset-binary codes (passed through
    untouched, preserving bit-exactness with offline runs; out-of-range
    integer codes are rejected with a clear error) or float PCM (quantized
    with the fixed gain).

    Constructed standalone it owns a private 1-row arena (the old
    per-stream-ring contract); the scheduler instead binds every stream's
    facade to a row of ONE shared ``RingArena`` so the hop hot path never
    touches these objects.  ``capacity_samples`` is a property of the
    arena: under a scheduler, the pool-wide ``inbox_samples`` wins over
    the per-stream config value.
    """

    def __init__(self, cfg: FrontendConfig | None = None, *,
                 arena: RingArena | None = None, slot: int = 0) -> None:
        self.cfg = cfg or FrontendConfig()
        if arena is None:
            arena = RingArena(1, self.cfg.capacity_samples)
            slot = 0
        self._arena = arena
        self._slot = slot
        arena.set_gain(slot, self.cfg.gain)

    def __len__(self) -> int:
        return self._arena.fill_of(self._slot)

    @property
    def samples_in(self) -> int:
        return int(self._arena.samples_in[self._slot])

    @property
    def chunks_in(self) -> int:
        """Chunks this stream has pushed (arena-counted, like
        ``samples_in``; duplicate-sid batch pushes count each chunk)."""
        return int(self._arena.chunks_in[self._slot])

    def push(self, audio: np.ndarray) -> None:
        self._arena.push(self._slot, audio)

    def pop(self, n: int) -> np.ndarray:
        """Oldest n samples as (n,) int32 u8-codes."""
        return self._arena.pop(self._slot, n)

    def pop_all(self) -> np.ndarray:
        return self.pop(len(self))

    def peek_all(self) -> np.ndarray:
        """Buffered samples without consuming them."""
        return self._arena.peek(self._slot)
