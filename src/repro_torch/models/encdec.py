"""Encoder-decoder stack (the seamless-m4t backbone) in PyTorch.

The port of the reference's ``repro/models/encdec.py``.  The modality
frontend is a stub, as in the reference: the caller supplies frame
embeddings (B, Sa, D).  Encoder: non-causal self-attention blocks over the
frames.  Decoder: causal self-attention, cross-attention to the encoder's
memory, and a SwiGLU MLP per block.  Both stacks hold their layers'
leaves stacked ``(n_layers, ...)`` and loop over views of them.  The
training loss (``lm_loss``) is the decoder's next-token cross-entropy
(``stack.chunked_ce_loss``, no aux term); in mode ``train`` each decoder
block is wrapped by ``RematPolicy(remat)``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, stack
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.scan_utils import scan
from repro_torch.sharding import act


def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.head_dim, quant_mode=cfg.quant_mode)


def _init_attn(cfg: ArchConfig, generator, device, lead) -> dict:
    return attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, device=device,
                               lead=lead)


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device) -> dict:
    """The reference's tree: ``enc_blocks`` and ``dec_blocks`` stacked
    (n_enc_layers, ...) / (n_layers, ...), norms float32, the rest bf16."""
    def norm(*lead):
        return layers.ones((*lead, cfg.d_model), device)

    ne, nd = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": layers.embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                   device=device),
        "enc_blocks": {
            "norm1": norm(*ne),
            "attn": _init_attn(cfg, generator, device, ne),
            "norm2": norm(*ne),
            "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                   device=device, lead=ne),
        },
        "dec_blocks": {
            "norm1": norm(*nd),
            "self_attn": _init_attn(cfg, generator, device, nd),
            "norm_x": norm(*nd),
            "cross_attn": _init_attn(cfg, generator, device, nd),
            "norm2": norm(*nd),
            "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                   device=device, lead=nd),
        },
        "enc_norm": norm(),
        "out_norm": norm(),
        "lm_head": layers.dense_init(generator, cfg.d_model,
                                     cfg.padded_vocab, device=device),
    }


def encode(cfg: ArchConfig, params, frames) -> torch.Tensor:
    """frames (B,S,D) -> encoder memory (B,S,D) bf16."""
    kw = dict(_attn_kw(cfg), rope_theta=cfg.rope_theta)

    def block(h, p):
        h = stack._residual(h, attn.attention_train(
            p["attn"], stack._norm(h, p["norm1"]), causal=False, **kw))
        h = stack._residual(h, layers.apply_mlp(
            p["mlp"], stack._norm(h, p["norm2"]), cfg.quant_mode))
        return h, None

    h = act.constrain(frames.to(COMPUTE_DTYPE), "dp", None, None)
    h, _ = scan(block, h, params["enc_blocks"])
    return layers.rmsnorm(h, params["enc_norm"])


def _dec_block(cfg: ArchConfig, p, h, memory, mode, cache=None,
               cache_len=None):
    kw = dict(_attn_kw(cfg), rope_theta=cfg.rope_theta)
    hn = stack._norm(h, p["norm1"])
    if mode == "train":
        o, new_cache = attn.attention_train(p["self_attn"], hn, **kw), None
    elif mode == "prefill":
        o, new_cache = attn.attention_prefill(p["self_attn"], hn, **kw)
    else:
        o, new_cache = attn.attention_decode(p["self_attn"], hn, cache,
                                             cache_len, **kw)
    h = stack._residual(h, o)
    h = stack._residual(h, attn.cross_attention(
        p["cross_attn"], stack._norm(h, p["norm_x"]), memory,
        **_attn_kw(cfg)))
    h = stack._residual(h, layers.apply_mlp(
        p["mlp"], stack._norm(h, p["norm2"]), cfg.quant_mode))
    return h, new_cache


def forward_hidden(cfg: ArchConfig, params, tokens, frontend,
                   mode: str = "train", remat: str = "block"):
    """Encoder + decoder blocks, no output head -> (h, caches, memory);
    caches (k, v) stacked (n_layers, ...) in mode 'prefill'.  In mode
    ``train`` each decoder block runs under ``layers.RematPolicy(remat)``
    (the encoder's blocks are not wrapped, as in the reference)."""
    memory = encode(cfg, params, frontend)
    h = act.constrain(stack.embed_lookup(params, tokens), "dp", None, None)

    def block(h, p):
        return _dec_block(cfg, p, h, memory, mode)

    policy = layers.RematPolicy(remat)
    blk = policy.wrap(block) if mode == "train" else block
    h, caches = scan(blk, h, params["dec_blocks"])
    return h, caches, memory


def forward(cfg: ArchConfig, params, tokens, frontend, mode: str = "train",
            remat: str = "block"):
    """tokens (B,St), frontend frames (B,Sa,D) -> (float32 logits, aux 0)
    in mode 'train', (logits, {"self": caches, "memory": memory}) in mode
    'prefill'."""
    with layers.lm_precision():
        h, caches, memory = forward_hidden(cfg, params, tokens, frontend,
                                           mode, remat)
        logits = stack._logits(cfg, params, h)
    if mode == "prefill":
        return logits, {"self": caches, "memory": memory}
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      mem_seq: int, *, device) -> dict:
    """The clock, zeroed self-attention caches (n_layers, B, max_seq, Hk,
    Dh) bf16 and a zeroed encoder memory (B, mem_seq, D) bf16."""
    def kv():
        return torch.zeros((cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                            cfg.head_dim), dtype=torch.bfloat16,
                           device=device)

    return {
        "cache_len": torch.zeros((), dtype=torch.int32, device=device),
        "self": (kv(), kv()),
        "memory": torch.zeros((batch, mem_seq, cfg.d_model),
                              dtype=torch.bfloat16, device=device),
    }


def decode_step(cfg: ArchConfig, params, state: dict, tokens):
    """tokens (B,1) -> (float32 logits (B,1,V), new state).  Consumes
    ``state``: each layer's k/v row is written in place, and the new
    state shares the caches and the memory; no host synchronisation."""
    memory = state["memory"]
    cache_len = state["cache_len"]
    k, v = state["self"]
    with layers.lm_precision():
        h = act.constrain(stack.embed_lookup(params, tokens), "dp", None,
                          None)
        for r in range(cfg.n_layers):
            h, _ = _dec_block(cfg, stack.index_tree(params["dec_blocks"], r),
                              h, memory, "decode", cache=(k[r], v[r]),
                              cache_len=cache_len)
        logits = stack._logits(cfg, params, h)
    return logits, {"cache_len": cache_len + 1, "self": state["self"],
                    "memory": memory}


def decode_shards(cfg: ArchConfig, params: list, states: list,
                  tokens: list):
    """:func:`decode_step` of S shards of one batch, each on its own
    device with its params copy ``params[s]``; no layer mixes rows, so
    the shards need no exchange and step one after the other.  -> (each
    shard's logits, each shard's new state)."""
    out = [decode_step(cfg, p, st, t)
           for p, st, t in zip(params, states, tokens)]
    return [lg for lg, _ in out], [st for _, st in out]


def lm_loss(cfg: ArchConfig, params, tokens, labels, frontend,
            remat: str = "block", loss_chunk: int = 512):
    """The decoder's next-token cross-entropy over the tokens (no aux
    term), forward and backward under ``layers.lm_precision``."""
    with layers.lm_precision():
        h, _, _ = forward_hidden(cfg, params, tokens, frontend, remat=remat)
        h = act.constrain(h, "dp", None, None)
        w32 = stack._head(cfg, params)
        loss = stack.chunked_ce_loss(
            functools.partial(stack._project, norm=params["out_norm"],
                              w32=w32),
            h, labels, cfg.vocab, cfg.padded_vocab, chunk=loss_chunk)
    return layers.backward_at_lm_precision(loss)
