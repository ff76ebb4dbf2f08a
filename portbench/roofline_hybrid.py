"""The operations of one decode tick of a Jamba hybrid (Mamba, attention,
dense and MoE FFNs), from its config file; the peaks are ``roofline``'s.

A tick runs one token of each of ``rows`` sequences through every layer.
Counted, 2 FLOPs a multiply-add: the Mamba mixer's in_proj, conv, x_proj,
dt_proj, its scan (one multiply-add a state element for the update and
one for the read-out) and out_proj; attention's projections and its two
products over the positions attended; the dense SwiGLUs; each MoE
layer's router over all the published experts and the held experts'
SwiGLUs at the (token, slot) pairs they keep; the head.  Norms,
activations and the dispatch's bookkeeping are not counted.
"""
from __future__ import annotations

from portbench.inputs.jamba import counts


def token_flops(cfg: dict, context: int) -> float:
    """FLOPs of one token at ``context`` positions attended, without the
    experts: the mixers, the dense FFNs, the routers and the head."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // heads
    di = cfg["mamba_expand"] * d
    n, r = cfg["mamba_d_state"], cfg["mamba_dt_rank"]
    c = counts(cfg)
    mamba = d * 2 * di + cfg["mamba_d_conv"] * di + di * (r + 2 * n) \
        + r * di + 2 * di * n + di * d
    attn = 2 * d * heads * dh + 2 * d * kv * dh + 2 * heads * dh * context
    macs = c["mamba"] * mamba + c["attn"] * attn \
        + c["dense"] * 3 * d * cfg["intermediate_size"] \
        + c["moe"] * d * cfg["published_num_experts"] + d * v
    return 2.0 * macs


def expert_flops(cfg: dict, kept: float) -> float:
    """FLOPs of ``kept`` (token, slot) pairs through one expert's SwiGLU."""
    return 2.0 * kept * 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def tick_flops(cfg: dict, rows: int, context: int,
               kept_per_layer: float) -> float:
    """FLOPs of one decode tick of ``rows`` tokens at ``context`` positions
    attended, each MoE layer's held experts keeping ``kept_per_layer``
    pairs."""
    return rows * token_flops(cfg, context) \
        + counts(cfg)["moe"] * expert_flops(cfg, kept_per_layer)
