"""Declarative spec for binary 1-D CNNs — the compiler's input language.

A model is a sequence of layers over a (length, channels) feature map:

  Conv1D : ternary weights (K, Cin, Cout), stride/pad, optional fused pool,
           SA binary output or raw counts; multi-bit input via bit-serial.
  Pool   : standalone max-pool (PWB bypass).
  GAP    : global average pool -> 8-bit counts.
  FC     : dense (Cin, Cout) = Conv1D with K=1 on a length-1 map, but kept
           explicit because its input may be multi-bit GAP counts.

The same spec drives (a) the QAT training graph (models/kws.py), (b) the
ISA compiler, (c) the latency/energy analysis.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Conv1DSpec:
    cin: int
    cout: int
    k: int
    stride: int = 1
    pad: int = 0
    pool: int = 1            # fused max-pool window (1 = none)
    in_bits: int = 1         # input precision (8 for the first layer)
    in_offset: int = 0       # offset-binary zero point (128 for u8 audio)
    out_raw: bool = False    # raw counts instead of SA binary
    name: str = "conv"

    def out_len(self, in_len: int) -> int:
        lo = (in_len + 2 * self.pad - self.k) // self.stride + 1
        return lo // self.pool if self.pool > 1 else lo

    def conv_len(self, in_len: int) -> int:
        return (in_len + 2 * self.pad - self.k) // self.stride + 1

    @property
    def weights(self) -> int:
        return self.k * self.cin * self.cout

    def macs(self, in_len: int) -> int:
        return self.weights * self.conv_len(in_len)

    @property
    def rows(self) -> int:
        """Macro wordlines the layer needs (Cin x K receptive field)."""
        return self.cin * self.k


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    channels: int
    pool: int
    name: str = "pool"

    def out_len(self, in_len: int) -> int:
        return in_len // self.pool


@dataclasses.dataclass(frozen=True)
class GAPSpec:
    channels: int
    name: str = "gap"

    def out_len(self, in_len: int) -> int:
        del in_len
        return 1


@dataclasses.dataclass(frozen=True)
class FCSpec:
    cin: int
    cout: int
    in_bits: int = 1
    in_offset: int = 0
    out_raw: bool = False
    name: str = "fc"

    @property
    def weights(self) -> int:
        return self.cin * self.cout

    @property
    def macs(self) -> int:
        return self.weights

    @property
    def rows(self) -> int:
        return self.cin


LayerSpec = Conv1DSpec | PoolSpec | GAPSpec | FCSpec


@dataclasses.dataclass(frozen=True)
class CNN1DSpec:
    """Whole-model spec: input geometry + layer list."""

    in_len: int
    in_channels: int
    in_bits: int
    layers: tuple[LayerSpec, ...]
    name: str = "cnn1d"

    def trace_shapes(self) -> list[tuple[int, int]]:
        """(length, channels) after each layer (length=1 for GAP/FC)."""
        shapes = []
        l, c = self.in_len, self.in_channels
        for spec in self.layers:
            if isinstance(spec, Conv1DSpec):
                assert spec.cin == c, f"{spec.name}: cin {spec.cin} != {c}"
                l, c = spec.out_len(l), spec.cout
            elif isinstance(spec, PoolSpec):
                assert spec.channels == c
                l = spec.out_len(l)
            elif isinstance(spec, GAPSpec):
                assert spec.channels == c
                l = 1
            elif isinstance(spec, FCSpec):
                assert spec.cin == c, f"{spec.name}: cin {spec.cin} != {c}"
                l, c = 1, spec.cout
            shapes.append((l, c))
        return shapes

    @property
    def total_weights(self) -> int:
        return sum(
            s.weights for s in self.layers if isinstance(s, (Conv1DSpec, FCSpec))
        )

    @property
    def total_macs(self) -> int:
        macs, l = 0, self.in_len
        for spec in self.layers:
            if isinstance(spec, Conv1DSpec):
                macs += spec.macs(l)
                l = spec.out_len(l)
            elif isinstance(spec, PoolSpec):
                l = spec.out_len(l)
            elif isinstance(spec, GAPSpec):
                l = 1
            elif isinstance(spec, FCSpec):
                macs += spec.macs
        return macs

    @property
    def model_size_kb(self) -> float:
        """Paper's unit: weights counted in Kb (1 weight = 1 bit pre-TWM)."""
        return self.total_weights / 1024.0
