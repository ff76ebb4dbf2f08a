"""Model zoo entry points of the port, dispatched on ArchConfig.family.

The port of the reference's ``repro/models/api.py``; the engine and the
launcher import only this module:

  init_params(cfg, generator=, device=)       parameter tree
  prefill_fn(cfg)(params, batch)              logits + caches
  decode_fn(cfg)(params, state, tok)          one-token step
  init_decode_state(cfg, batch, seq, device=) zeroed caches + clock

Every entry point runs on the card unless the caller names another
device (``ops.resolve_device``: with no card, asking for it raises).  The
``dense`` and ``vlm`` families are served; ``encdec`` and the MoE, SSM
and hybrid stacks raise ``NotImplementedError`` naming ROADMAP A.13b.
``loss_fn`` waits for LM training (A.13c).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import stack
from repro_torch.utils.tree import tree_count_params


def _dense_stack(cfg: ArchConfig) -> None:
    if cfg.family == "encdec":
        raise stack._later(f"{cfg.name}: the encoder-decoder family")


def init_params(cfg: ArchConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random weights drawn from ``generator`` (default: one seeded 0 on
    the target device); no ``device`` means the card."""
    _dense_stack(cfg)
    device = ops.resolve_device(None, device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    return stack.init_params(cfg, generator, device)


def prefill_fn(cfg: ArchConfig):
    _dense_stack(cfg)

    def prefill(params, batch):
        return stack.forward(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"), mode="prefill")
    return prefill


def decode_fn(cfg: ArchConfig):
    _dense_stack(cfg)

    def step(params, state, tokens):
        return stack.decode_step(cfg, params, state, tokens)
    return step


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      kv_replication: int = 1, *, device=None) -> dict:
    _dense_stack(cfg)
    return stack.init_decode_state(cfg, batch, max_seq, kv_replication,
                                   device=ops.resolve_device(None, device))


def param_count(cfg: ArchConfig) -> int:
    """Parameter count, from the tree built on the ``meta`` device
    (nothing allocated)."""
    return tree_count_params(init_params(cfg, device="meta"))


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token: all of them for the families served here
    (the MoE count, top_k + shared experts only, waits for A.13b)."""
    if cfg.moe is not None:
        raise stack._later(f"{cfg.name}: MoE active parameters")
    return param_count(cfg)
