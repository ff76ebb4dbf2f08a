"""Pooling-Write Block (paper §II-H, Fig. 6).

Two paths:
  * fused: the SA output stream of a convolution passes through the OR-tree
    max-pool before the SRAM write — zero extra cycles (pipelined), and the
    OFM is written once, already pooled.
  * bypass: the macro is bypassed; the PWB reads an existing feature map and
    pools it standalone (max-pool or global-average-pool as popcount
    counters).  Costs read+write cycles through the 128-bit pool unit port.

This module is the *unit*: cycle accounting (Python ints from shapes) +
the mode decision, as programmed by the MAC instruction's ``fuse``/``ltype``
bits, and the two pooling functions as torch ops on the caller's device.
"""
from __future__ import annotations

import dataclasses

import torch

# Pool-unit datapath width in bypass mode.  The paper does not specify it;
# 64 bits puts the reconstructed fused-vs-independent latency reduction
# closest to the paper's 35.9% (see benchmarks/pwb_latency.py for the
# 32/64/128-bit sensitivity sweep).  Fused-mode pooling is width-independent
# (it rides the macro write-back pipeline).
POOL_UNIT_BITS = 64


def fused_pool_extra_cycles() -> int:
    """Fused conv+pool adds no macro cycles (pipelined write-back)."""
    return 0


def standalone_pool_cycles(length: int, channels: int, pool: int) -> int:
    """Bypass-path pooling: stream L positions through the 128-bit unit.

    reads: one cycle per position per 128-bit channel group; writes: one per
    output window per group (single-port feature SRAM, §II-F).
    """
    groups = (channels + POOL_UNIT_BITS - 1) // POOL_UNIT_BITS
    out_len = length // pool if pool > 0 else 1
    return length * groups + out_len * groups


def gap_cycles(length: int, channels: int) -> int:
    """Global average pool (counts accumulate in the PWB counters)."""
    return standalone_pool_cycles(length, channels, pool=0)


def maxpool_bits(y: torch.Tensor, pool: int) -> torch.Tensor:
    """(L, C) 0/1 -> (L//pool, C): OR over non-overlapping windows."""
    l = (y.shape[0] // pool) * pool
    return y[:l].reshape(l // pool, pool, y.shape[1]).amax(1)


def gap_counts(y: torch.Tensor) -> torch.Tensor:
    """(L, C) 0/1 -> (C,) integer counts (8-bit saturating, as the PWB
    counters are 8 bits wide): ``torch.uint8``."""
    c = y.to(torch.int64).sum(0)
    return c.clamp(max=255).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class PoolPlanEntry:
    """How one pooling op executes: fused into the producing conv or not."""

    fused: bool
    pool: int
    length: int     # pre-pool length
    channels: int

    @property
    def extra_cycles(self) -> int:
        if self.fused:
            return fused_pool_extra_cycles()
        return standalone_pool_cycles(self.length, self.channels, self.pool)
