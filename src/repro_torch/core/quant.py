"""Quantization primitives for the PSCNN binary/ternary regime (PyTorch).

The port's copy of the reference's ``repro/core/quant.py``: the
straight-through quantizers that quantization-aware training uses
(``binarize_act``, ``ternarize_weight``, each a
``torch.autograd.Function``), ``PACK``, ``pack_bits`` (with
``unpack_bits`` and the numpy ``np_pack_bits``), ``ternary_planes`` and
``planes_to_ternary``, ``pad_to_multiple``, and the folded batch-norm
threshold (``fold_bn_to_threshold``, ``apply_threshold``).

Packed words are carried as ``int32`` bit patterns, not ``uint32``: CUDA
PyTorch has few ``uint32`` ops, and the kernels cast each word to
``unsigned`` themselves.  Channel ``c`` sits at bit ``c % 32`` of word
``c // 32``, as in the reference; ``word.view(torch.uint32)`` (or
``.numpy().view(np.uint32)``) gives the reference's ``uint32`` words.
"""
from __future__ import annotations

import numpy as np
import torch

PACK = 32  # bits per packed word


# ---------------------------------------------------------------------------
# Straight-through estimators
# ---------------------------------------------------------------------------

class _BinarizeAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class _TernarizeWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, threshold_scale):
        delta = threshold_scale * w.abs().mean()
        return (torch.sign(w) * (w.abs() > delta)).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def binarize_act(x: torch.Tensor) -> torch.Tensor:
    """Binary activation {1, 0}: the sense-amplifier decision of eq. (1).

    Forward: 1 where x >= 0, else 0, in x's dtype.  Backward: clipped
    straight-through, the gradient passing where |x| <= 1 (the standard
    BNN hard-tanh window)."""
    return _BinarizeAct.apply(x)


def ternarize_weight(w: torch.Tensor, threshold_scale: float = 0.05
                     ) -> torch.Tensor:
    """Ternary weight {-1, 0, +1} with a per-tensor magnitude threshold
    ``delta = threshold_scale * mean(|w|)`` (TWN-style, in w's dtype).
    Backward: the identity (the weights live in a float32 shadow);
    ``threshold_scale`` gets no gradient."""
    return _TernarizeWeight.apply(w, threshold_scale)


def ternary_planes(w_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a ternary {-1, 0, 1} tensor into (positive, negative) 0/1
    int32 planes: the TWM cell pair of each weight."""
    return (w_t > 0).to(torch.int32), (w_t < 0).to(torch.int32)


def planes_to_ternary(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ternary_planes`: int32 ``pos - neg``."""
    return pos.to(torch.int32) - neg.to(torch.int32)


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


def np_pack_bits(bits: np.ndarray, axis: int = -1) -> np.ndarray:
    """NumPy twin of :func:`pack_bits` for host-side weight preparation:
    ``uint32`` words (the reference's dtype)."""
    axis = axis % bits.ndim
    n = bits.shape[axis]
    if n % PACK:
        raise ValueError(f"pack axis length {n} not a multiple of {PACK}")
    moved = np.moveaxis(bits, axis, -1).astype(np.uint32)
    grouped = moved.reshape(*moved.shape[:-1], n // PACK, PACK)
    shifts = np.arange(PACK, dtype=np.uint32)
    packed = (grouped << shifts).sum(axis=-1).astype(np.uint32)
    return np.moveaxis(packed, -1, axis)


# ---------------------------------------------------------------------------
# Folded batch-norm threshold (the "theta" the SA compares against)
# ---------------------------------------------------------------------------

def fold_bn_to_threshold(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BN + sign into a popcount threshold: ``sign(gamma * (s - mean)
    / sqrt(var + eps) + beta)`` is ``s >= mean - beta * sqrt(var + eps) /
    gamma`` for gamma > 0, and the inverted compare for gamma < 0.
    Returns ``(threshold, flip)``."""
    gamma, beta, mean, var = (torch.as_tensor(v)
                              for v in (gamma, beta, mean, var))
    std = torch.sqrt(var + eps)
    safe = torch.where(gamma == 0, torch.full_like(gamma, 1e-9), gamma)
    thr = mean - beta * std / safe
    return thr, gamma < 0


def apply_threshold(s: torch.Tensor, thr, flip) -> torch.Tensor:
    """Binary SA output of the popcount difference ``s``: ``s >= thr``
    xor ``flip``, as ``torch.uint32`` {0, 1} (the reference's dtype)."""
    ge = s >= torch.as_tensor(thr, device=s.device)
    out = ge ^ (torch.as_tensor(flip, device=s.device) != 0)
    return out.to(torch.int32).view(torch.uint32)
