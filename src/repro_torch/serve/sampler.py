"""Token samplers (greedy / temperature / top-k) over padded-vocab logits.

The port of the reference's ``repro/serve/sampler.py``.  ``sample`` draws
from an explicit ``torch.Generator`` (Gumbel-max, as
``jax.random.categorical`` samples); its draws cannot equal
``jax.random``'s, only its distribution does.
"""
from __future__ import annotations

import torch


def mask_padded(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Kill the vocab-padding columns so they can never be sampled."""
    if logits.shape[-1] == vocab:
        return logits
    out = logits.clone()
    out[..., vocab:] = float("-inf")
    return out


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over the real vocab (the first index on ties, as
    ``jnp.argmax``), int32."""
    return logits[..., :vocab].argmax(dim=-1).to(torch.int32)


def sample(generator: torch.Generator, logits: torch.Tensor, vocab: int,
           temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    logits = mask_padded(logits, vocab).to(torch.float32)
    if temperature <= 0:
        return greedy(logits, vocab)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1).to(torch.int32)
