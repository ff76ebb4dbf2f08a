"""Deterministic synthetic LM token pipeline (host-sharded).

The port of the reference's ``repro/data/lm_data.py``.  Every batch is a
pure function of (seed, step, host_id), so a restart after a failure
resumes the exact data order with no loss or duplication, the contract
the train loop relies on.  Tokens and labels are the reference's numpy
int32 arrays, byte for byte.

The token stream is an order-2 Markov chain over the vocab, so the loss
has learnable structure, not uniform noise.  The frontend embeddings (VLM
and encoder-decoder families) are the reference's float32 draw cast to
``torch.bfloat16`` on the host (round to nearest even, as ``ml_dtypes``
rounds), so the bits equal the reference's bf16 array's without
``ml_dtypes``.  :func:`to_device` moves a batch to the device a step runs
on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    microbatches: int = 1
    frontend_tokens: int = 0
    frontend_dim: int = 0


def _markov_batch(rng: np.random.Generator, b: int, s: int, vocab: int):
    """Tokens with short-range structure: x[t+1] = f(x[t]) + noise."""
    base = rng.integers(0, vocab, (b, 1))
    steps = rng.integers(1, 7, (b, s - 1))
    noise = (rng.random((b, s - 1)) < 0.1) * rng.integers(0, vocab, (b, s - 1))
    toks = np.concatenate([base, steps], axis=1).astype(np.int64)
    toks = np.cumsum(toks, axis=1) % vocab
    toks[:, 1:] = np.where(noise > 0, noise, toks[:, 1:])
    return toks.astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The batch for a given global step (deterministic, host-sharded):
    ``tokens`` and ``labels`` int32 numpy arrays (B, S), and with
    ``frontend_tokens`` a bf16 CPU tensor (B, frontend_tokens,
    frontend_dim); with ``microbatches`` > 1 every leaf is reshaped
    (microbatches, B / microbatches, ...)."""
    assert cfg.global_batch % cfg.n_hosts == 0
    per_host = cfg.global_batch // cfg.n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )
    toks = _markov_batch(rng, per_host, cfg.seq_len + 1, cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_tokens:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (per_host, cfg.frontend_tokens, cfg.frontend_dim),
            dtype=np.float32)).to(torch.bfloat16)
    if cfg.microbatches > 1:
        assert per_host % cfg.microbatches == 0
        mb = per_host // cfg.microbatches
        batch = {
            k: v.reshape(cfg.microbatches, mb, *v.shape[1:])
            for k, v in batch.items()
        }
    return batch


def iterator(cfg: DataConfig, start_step: int = 0):
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1


def to_device(batch: dict, device=None) -> dict:
    """A batch as tensors on ``device`` (default: the card, by
    ``ops.resolve_device``): tokens and labels int64, the frontend
    bf16."""
    dev = ops.resolve_device(None, device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        dtype = torch.bfloat16 if k == "frontend" else torch.int64
        out[k] = t.to(device=dev, dtype=dtype)
    return out
