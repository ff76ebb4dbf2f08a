"""Plain PyTorch oracles for the kernel library (the reference's
``repro/kernels/ref.py``).

Exact integer arithmetic, the digital semantics of the PSCNN macro: every
contraction runs in float64, which holds each partial sum of these layers
exactly (all < 2^53), and the result is cast back to int32.  They are
the ground truth of the port's kernel tests, independent of the packed
layouts the kernels read.

Conventions, as in the reference:

* binary activations are 0/1 tensors laid out ``(..., L, C)``; ``sa``
  outputs are ``torch.uint32`` {0, 1}, raw outputs int32;
* ternary weights are {-1, 0, 1}; conv weights ``(K, Cin, Cout)``, linear
  weights ``(Cin, Cout)``;
* ``thr``/``flip`` come from :func:`repro_torch.core.quant.fold_bn_to_threshold`;
* pooling binary activations is max-pool = OR over the window (the PWB's
  OR-tree), dropping the remainder.

Inputs may be any integer dtype, ``torch.uint32`` included (CPU PyTorch
has few ``uint32`` ops, so each oracle first widens to int64).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def _dot(eq: str, *xs) -> torch.Tensor:
    return torch.einsum(eq, *(x.to(torch.float64) for x in xs)).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Dense (FC) layer
# ---------------------------------------------------------------------------

def ref_twm_matmul(x_bits, w_t) -> torch.Tensor:
    """Raw popcount difference: (M, K) {0,1} x (K, N) {-1,0,1} -> (M, N)
    int32, as ``x @ pos - x @ neg`` over the TWM planes."""
    pos, neg = quant.ternary_planes(_i64(w_t))
    x = _i64(x_bits)
    return _dot("mk,kn->mn", x, pos) - _dot("mk,kn->mn", x, neg)


def ref_twm_matmul_sa(x_bits, w_t, thr, flip) -> torch.Tensor:
    """Popcount difference followed by the SA threshold (uint32 bits)."""
    s = ref_twm_matmul(x_bits, w_t)
    return quant.apply_threshold(s.to(torch.float32), thr, flip)


# ---------------------------------------------------------------------------
# 1-D convolution (binary activations, ternary weights)
# ---------------------------------------------------------------------------

def _shifted_views(x_bits, k: int, stride: int, pad: int) -> torch.Tensor:
    """Stack of K strided views: ``out[tap, t, c] = x_pad[t * stride +
    tap, c]`` -> (K, L_out, C), in the input's dtype."""
    x_bits = torch.as_tensor(x_bits)
    x_pad = torch.nn.functional.pad(_i64(x_bits), (0, 0, pad, pad))
    l_out = conv1d_out_len(x_bits.shape[0], k, stride, pad)
    span = (l_out - 1) * stride + 1
    views = torch.stack([x_pad[t:t + span:stride] for t in range(k)], 0)
    return views.to(x_bits.dtype)


def conv1d_out_len(length: int, k: int, stride: int, pad: int) -> int:
    return (length + 2 * pad - k) // stride + 1


def ref_bnn_conv1d(x_bits, w_t, stride: int = 1, pad: int = 0
                   ) -> torch.Tensor:
    """Raw conv popcount difference: x_bits (L, Cin) {0,1}; w_t (K, Cin,
    Cout) {-1,0,1} -> (L_out, Cout) int32."""
    w = _i64(w_t)
    xs = _shifted_views(x_bits, w.shape[0], stride, pad)
    return _dot("klc,kcn->ln", xs, w)


def ref_bnn_conv1d_sa(x_bits, w_t, thr, flip, stride: int = 1,
                      pad: int = 0, pool: int = 1) -> torch.Tensor:
    """Conv -> SA threshold -> (optional) fused max-pool (the PWB path)."""
    s = ref_bnn_conv1d(x_bits, w_t, stride, pad)
    y = quant.apply_threshold(s.to(torch.float32), thr, flip)
    if pool > 1:
        y = ref_maxpool1d(y, pool)
    return y


def ref_bnn_conv1d_batched(x_bits, w_t, stride: int = 1, pad: int = 0
                           ) -> torch.Tensor:
    """Batched raw conv: (B, L, Cin) {0,1} x (K, Cin, Cout) -> (B, L_out,
    Cout) int32."""
    return torch.stack([ref_bnn_conv1d(x, w_t, stride, pad)
                        for x in torch.as_tensor(x_bits)])


def ref_maxpool1d(y_bits, pool: int) -> torch.Tensor:
    """Binary max-pool = OR over non-overlapping windows (drops the
    remainder); keeps the input's dtype."""
    y = torch.as_tensor(y_bits)
    n = y.shape[0] // pool
    return _i64(y)[:n * pool].reshape(n, pool, *y.shape[1:]).amax(1).to(
        y.dtype)


def ref_gap_counts(y_bits) -> torch.Tensor:
    """Global-average-pool as integer counts (PWB bypass + popcount
    counter): (L, C) -> (C,) int32."""
    return _i64(y_bits).sum(0).to(torch.int32)


# ---------------------------------------------------------------------------
# Bit-serial multi-bit input (first layer: 8-bit audio; FC after GAP counts)
# ---------------------------------------------------------------------------

def ref_bitserial_conv1d(x_u, w_t, bits: int, offset: int = 0,
                         stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Multi-bit-input conv as ``bits`` binary passes weighted 2^b.

    x_u (L, Cin) unsigned codes < 2^bits (offset-binary; ``offset *
    sum(w)`` is subtracted after accumulation).  Spatial padding uses the
    offset code.  Returns raw int32 (L_out, Cout)."""
    x = _i64(x_u)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, pad, pad), value=offset)
    acc = None
    for b in range(bits):
        d = ref_bnn_conv1d((x >> b) & 1, w_t, stride, 0) * (1 << b)
        acc = d if acc is None else acc + d
    if offset:
        acc = acc - offset * _i64(w_t).sum((0, 1)).to(torch.int32)[None, :]
    return acc


def ref_bitserial_matmul(x_u, w_t, bits: int, offset: int = 0
                         ) -> torch.Tensor:
    """Bit-serial dense layer: (M, K) codes x (K, N) ternary -> int32."""
    x = _i64(x_u)
    acc = None
    for b in range(bits):
        d = ref_twm_matmul((x >> b) & 1, w_t) * (1 << b)
        acc = d if acc is None else acc + d
    if offset:
        acc = acc - offset * _i64(w_t).sum(0).to(torch.int32)[None, :]
    return acc


# ---------------------------------------------------------------------------
# Packed-domain oracle (the exact 32-bit words the kernels see)
# ---------------------------------------------------------------------------

def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64."""
    v = v & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def ref_popcount_gemm_packed(x_packed, wp_packed, wn_packed
                             ) -> torch.Tensor:
    """(M, Kw) words, (Kw, N) word planes -> (M, N) int32
    ``sum_k popc(x & wp) - popc(x & wn)``."""
    x = _i64(x_packed)[:, :, None]
    pp = _popcount(x & _i64(wp_packed)[None])
    pn = _popcount(x & _i64(wn_packed)[None])
    return (pp - pn).sum(1).to(torch.int32)
