"""Shared building blocks for the LM-family architectures (PyTorch).

The port of the reference's ``repro/models/layers.py``.  Everything is
functional: ``init_*`` builds parameter trees (dicts of tensors) from an
explicit ``torch.Generator``, ``apply``-style functions consume them.
Weights are stored in ``PARAM_DTYPE`` (bf16), compute runs in bf16 with
float32 accumulations where the reference asks for them.

TernaryLinear is the paper's technique lifted into the LM stack:
BitNet-style linears whose weights ternarize {-1,0,+1} with a per-tensor
scale, run as masked-sign matmuls, as the reference runs them.

Precision: :func:`lm_precision` holds the LM entry points to the
reference's arithmetic on the card: float32 matmuls at full precision (no
TF32) and bf16 matmuls without reduced-precision (bf16) partial sums.
:func:`backward_at_lm_precision` marks a loss so that its backward pass,
and every activation recomputed in it, runs under the same settings.

Activation checkpointing: :class:`RematPolicy` (``none``, ``block``,
``dots``) wraps a block as the reference's ``jax.checkpoint`` policies do,
and :func:`checkpoint` recomputes one step of a chunked loop in the
backward, where the reference puts ``jax.checkpoint`` on a scan's body.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core import quant
from repro_torch.utils.tree import tree_leaves

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


@contextlib.contextmanager
def lm_precision():
    """Inside the block: float32 matmuls at "highest" precision (no TF32)
    and no bf16 reduced-precision reductions in bf16 matmuls (cuBLAS
    split-K partial sums stay float32, as XLA accumulates them); both
    settings restored after."""
    prev = torch.get_float32_matmul_precision()
    flags = torch.backends.cuda.matmul
    prev_bf16 = flags.allow_bf16_reduced_precision_reduction
    torch.set_float32_matmul_precision("highest")
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        flags.allow_bf16_reduced_precision_reduction = prev_bf16


class _BackwardAtLMPrecision(torch.autograd.Function):
    """The identity on a loss.  Its backward is the first node of the
    backward pass: it enters :func:`lm_precision` and queues the exit at
    the end of the pass (both settings are process-wide, so they hold on
    the autograd engine's device threads too)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        scope = lm_precision()
        scope.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: scope.__exit__(None, None, None))
        return grad


def backward_at_lm_precision(loss: torch.Tensor) -> torch.Tensor:
    """``loss``, unchanged, whose backward pass (the gradients and the
    checkpointed recomputations) runs under :func:`lm_precision`,
    whatever float32 matmul precision the process has set."""
    if not loss.requires_grad:
        return loss
    return _BackwardAtLMPrecision.apply(loss)


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------

def _takes_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves(args))


def checkpoint(fn, *args, policy=None):
    """``fn(*args)`` with its activations dropped and recomputed in the
    backward (the reference's ``jax.checkpoint`` on a scan's step), or
    with ``policy(ctx, op, ...)`` only those it does not save; a plain
    call where no gradient is taken."""
    if not _takes_grad(args):
        return fn(*args)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, policy)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


#: the products whose outputs the ``dots`` policy keeps: the non-batched
#: matrix products (``checkpoint_dots_with_no_batch_dims``); ``torch.matmul``
#: of (B, S, D) by (D, F) runs as one ``mm``, a batched einsum as ``bmm``
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """Activation checkpointing policy selector for the train loop:
    ``none`` keeps every activation, ``block`` recomputes the wrapped
    block in the backward, ``dots`` keeps only the outputs of the
    non-batched matrix products and recomputes the rest."""

    mode: str = "block"  # 'none' | 'block' | 'dots'

    def wrap(self, fn):
        if self.mode == "none":
            return fn
        if self.mode == "block":
            return functools.partial(checkpoint, fn)
        if self.mode == "dots":
            return functools.partial(checkpoint, fn, policy=_save_dots)
        raise ValueError(self.mode)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal(generator: torch.Generator | None, shape, std: float, device,
           dtype=PARAM_DTYPE) -> torch.Tensor:
    """``std`` x a standard normal draw of ``shape`` in float32, cast to
    ``dtype`` on ``device``.  The draw is made on the generator's device;
    on the ``meta`` device nothing is drawn or allocated."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(std).to(device=device, dtype=dtype)


def ones(shape, device) -> torch.Tensor:
    """A float32 norm gain of ones (the reference's ``jnp.ones``)."""
    return torch.ones(shape, dtype=torch.float32, device=device)


def dense_init(generator, in_dim: int, out_dim: int, *, device, lead=(),
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """(*lead, in_dim, out_dim) weights, std 1/sqrt(in_dim)."""
    return normal(generator, (*lead, in_dim, out_dim),
                  1.0 / math.sqrt(in_dim), device, dtype)


def embed_init(generator, vocab: int, dim: int, *, device,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    return normal(generator, (vocab, dim), 0.02, device, dtype)


# ---------------------------------------------------------------------------
# Linear (+ ternary QAT mode)
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16 (float32 accumulation inside the matmul)."""
    return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


def ternary_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """PSCNN/BitNet-style ternary linear (the paper's arithmetic regime):
    w ternarizes (``core.quant.ternarize_weight``), a per-tensor scale
    keeps magnitudes, and the product runs as a bf16 matmul of
    integer-like values, as the reference's masked-sign matmul does."""
    w32 = w.to(torch.float32)
    scale = w32.abs().mean() + 1e-8
    w_t = quant.ternarize_weight(w32) * scale
    return torch.matmul(x.to(COMPUTE_DTYPE), w_t.to(COMPUTE_DTYPE))


def apply_linear(x: torch.Tensor, w: torch.Tensor,
                 quant_mode: str = "none") -> torch.Tensor:
    if quant_mode == "ternary":
        return ternary_linear(x, w)
    return linear(x, w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    return out.to(x.dtype)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

_FREQS: dict = {}


def rope_freqs(d_head: int, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    """(d_head/2,) float32 inverse frequencies, made once per (d_head,
    theta, device) and reused (a decode tick would otherwise rebuild them
    in every layer)."""
    key = (d_head, float(theta), str(device))
    f = _FREQS.get(key)
    if f is None:
        exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
        f = _FREQS[key] = 1.0 / torch.pow(
            torch.tensor(theta, dtype=torch.float32, device=device), exps)
    return f


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Rotates
    the interleaved pairs (``0::2``, ``1::2``), as the reference does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, *, device,
             lead=()) -> dict:
    return {
        "wi_gate": dense_init(generator, d_model, d_ff, device=device,
                              lead=lead),
        "wi_up": dense_init(generator, d_model, d_ff, device=device,
                            lead=lead),
        "wo": dense_init(generator, d_ff, d_model, device=device, lead=lead),
    }


def apply_mlp(p: dict, x: torch.Tensor,
              quant_mode: str = "none") -> torch.Tensor:
    g = apply_linear(x, p["wi_gate"], quant_mode)
    u = apply_linear(x, p["wi_up"], quant_mode)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(COMPUTE_DTYPE) * u
    return apply_linear(h, p["wo"], quant_mode)
