"""Bit packing and ternary planes for the popcount kernels (PyTorch).

The port's copy of the parts of the reference's ``repro/core/quant.py``
that the per-stage kernels need: ``PACK``, ``pack_bits``,
``ternary_planes`` and ``pad_to_multiple``.

Packed words are carried as ``int32`` bit patterns, not ``uint32``: CUDA
PyTorch has few ``uint32`` ops, and the kernels cast each word to
``unsigned`` themselves.  Channel ``c`` sits at bit ``c % 32`` of word
``c // 32``, as in the reference; ``word.view(torch.uint32)`` (or
``.numpy().view(np.uint32)``) gives the reference's ``uint32`` words.
"""
from __future__ import annotations

import torch

PACK = 32  # bits per packed word


def ternary_planes(w_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a ternary {-1, 0, 1} tensor into (positive, negative) 0/1
    int32 planes: the TWM cell pair of each weight."""
    return (w_t > 0).to(torch.int32), (w_t < 0).to(torch.int32)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int
                    ) -> torch.Tensor:
    """Zero-pad ``axis`` up to the next multiple (inactive wordlines)."""
    axis = axis % x.ndim
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], axis)


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a 0/1 tensor into int32 words along ``axis``, whose length must
    be a multiple of 32 (pad with zeros first).

    The words are summed in int64 and bit 31 is wrapped explicitly, so a
    word with its top bit set comes out as the negative int32 with the
    same bit pattern."""
    axis = axis % bits.ndim
    n = bits.shape[axis]
    if n % PACK:
        raise ValueError(f"pack axis length {n} not a multiple of {PACK}")
    moved = bits.movedim(axis, -1).to(torch.int64)
    grouped = moved.reshape(*moved.shape[:-1], n // PACK, PACK)
    shifts = torch.arange(PACK, dtype=torch.int64, device=bits.device)
    words = (grouped << shifts).sum(-1)
    words = words - ((words >> 31) << 32)   # [0, 2^32) -> int32 range
    return words.to(torch.int32).movedim(-1, axis)


def unpack_bits(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words -> int32 0/1 lanes, 32
    per word, along ``axis``."""
    axis = axis % words.ndim
    moved = words.movedim(axis, -1)
    shifts = torch.arange(PACK, dtype=torch.int32, device=words.device)
    lanes = (moved.unsqueeze(-1) >> shifts) & 1
    return lanes.reshape(*moved.shape[:-1], -1).movedim(-1, axis)
