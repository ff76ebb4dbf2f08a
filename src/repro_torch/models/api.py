"""Model zoo entry points of the port, dispatched on ArchConfig.family.

The port of the reference's ``repro/models/api.py``; the engine and the
launcher import only this module:

  init_params(cfg, generator=, device=)       parameter tree
  loss_fn(cfg, remat)(params, batch)          training loss (batch dict)
  prefill_fn(cfg)(params, batch)              logits + caches / states
  decode_fn(cfg)(params, state, tok)          one-token step
  decode_shards_fn(cfg)(params, states, toks) the step over S shards
  init_decode_state(cfg, batch, seq, device=) zeroed caches + clock

Every entry point runs on the card unless the caller names another
device (``ops.resolve_device``: with no card, asking for it raises).
Every family is served and trained: ``encdec`` through
``models.encdec``, the others (dense, vlm, moe, ssm, hybrid) through
``models.stack``.

:func:`params_from_numpy` and :func:`params_to_numpy` carry weights
between the reference's tree (through numpy) and the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import encdec, stack
from repro_torch.utils.tree import tree_count_params, tree_map


def init_params(cfg: ArchConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random weights drawn from ``generator`` (default: one seeded 0 on
    the target device); no ``device`` means the card."""
    device = ops.resolve_device(None, device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    if cfg.family == "encdec":
        return encdec.init_params(cfg, generator, device)
    return stack.init_params(cfg, generator, device)


def loss_fn(cfg: ArchConfig, remat: str = "block"):
    """-> loss(params, batch): the next-token cross-entropy of
    ``batch["tokens"]`` against ``batch["labels"]`` (and the routers' aux
    term; ``batch["frontend"]`` for the VLM and encoder-decoder families),
    a float32 0-d tensor.  The batch's tensors lie on the params' device
    (``data.lm_data.to_device``); ``remat`` is the blocks'
    ``layers.RematPolicy`` mode."""
    if cfg.family == "encdec":
        def loss(params, batch):
            return encdec.lm_loss(cfg, params, batch["tokens"],
                                  batch["labels"], batch["frontend"],
                                  remat=remat)
        return loss

    def loss(params, batch):
        return stack.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                             frontend=batch.get("frontend"), remat=remat)
    return loss


def prefill_fn(cfg: ArchConfig):
    if cfg.family == "encdec":
        def prefill(params, batch):
            return encdec.forward(cfg, params, batch["tokens"],
                                  batch["frontend"], mode="prefill")
        return prefill

    def prefill(params, batch):
        return stack.forward(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"), mode="prefill")
    return prefill


def decode_fn(cfg: ArchConfig):
    if cfg.family == "encdec":
        def step(params, state, tokens):
            return encdec.decode_step(cfg, params, state, tokens)
        return step

    def step(params, state, tokens):
        return stack.decode_step(cfg, params, state, tokens)
    return step


def decode_shards_fn(cfg: ArchConfig):
    """-> step(params, states, tokens): the one-token step of S shards of
    one batch (lists, shard ``s`` on its own device with its params
    copy ``params[s]``) -> (logits, states), lists in shard order."""
    mod = encdec if cfg.family == "encdec" else stack

    def step(params, states, tokens):
        return mod.decode_shards(cfg, params, states, tokens)
    return step


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      kv_replication: int = 1, *, device=None) -> dict:
    """The encoder-decoder family's state holds a zeroed memory of
    ``max_seq`` frames, as the reference's does."""
    device = ops.resolve_device(None, device)
    if cfg.family == "encdec":
        return encdec.init_decode_state(cfg, batch, max_seq, max_seq,
                                        device=device)
    return stack.init_decode_state(cfg, batch, max_seq, kv_replication,
                                   device=device)


def param_count(cfg: ArchConfig) -> int:
    """Parameter count, from the tree built on the ``meta`` device
    (nothing allocated)."""
    return tree_count_params(init_params(cfg, device="meta"))


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: the top_k routed and the shared
    experts only; of a layer that holds a share of the experts, as if a
    token's top_k were among them)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = sum(1 for _, f in stack.block_structure(cfg)
                       if f == "moe") * stack.n_repeats(cfg)
    per_expert = 3 * cfg.d_model * m.d_expert
    return total - n_moe_layers * (m.n_held - m.top_k) * per_expert


# ---------------------------------------------------------------------------
# Weights across the numpy bridge
# ---------------------------------------------------------------------------

def params_from_numpy(cfg: ArchConfig, tree, device=None) -> dict:
    """The reference's parameter tree for ``cfg`` (numpy arrays, or JAX
    arrays through ``np.asarray``) as the port's on ``device`` (default:
    the card, by ``ops.resolve_device``).  Each leaf takes the dtype of
    the port's own leaf at the same path (the tree built on the ``meta``
    device), which is the reference's: float32 for norm gains, the MoE
    router and the recurrent layers' gate and scan parameters, bf16
    elsewhere.  Float32 arrays are accepted for every leaf (bf16 ->
    float32 -> bf16 is lossless); ``ml_dtypes`` bf16 arrays are read as
    their raw 16-bit words, so ``ml_dtypes`` need not be installed."""
    device = ops.resolve_device(None, device)

    def leaf(a, like):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{cfg.name}: a leaf of shape {tuple(t.shape)} "
                             f"where the port's is {tuple(like.shape)}")
        return t.to(device=device, dtype=like.dtype)

    return tree_map(leaf, tree, init_params(cfg, device="meta"))


def params_to_numpy(params) -> dict:
    """The port's parameter tree as float32 numpy arrays on the host
    (numpy has no bf16; the values are the bf16 ones, exactly)."""
    return tree_map(lambda t: t.detach().to(torch.float32).cpu().numpy(),
                    params)
