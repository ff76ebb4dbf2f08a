"""The Jamba cells' weights, made from the seed on the device.

``make_weights`` draws every leaf with one call a stacked leaf, in the
dtype it is served in (bf16 matrices; float32 norm gains, router and the
Mamba mixer's conv, dt and scan parameters), from a ``torch.Generator``
on the device: normal with std ``1 / sqrt(fan_in)``, embeddings 0.02,
norm gains and ``D`` 1, ``A_log`` = log(1..N) per channel, the dt_proj
bias softplus^-1 of dt log-uniform in [1e-3, 1e-1] (the published Mamba
init).  Leaves are stacked by kind, in layer order: ``attn.*`` over the
attention layers, ``mamba.*`` over the Mamba layers, ``dense.*`` over the
dense-FFN layers, ``moe.*`` over the MoE layers (``moe.e_*`` hold the
experts this card holds).  Prompts are ``inputs/lm.py``'s.

The router is ``inputs/lm.py``'s construction at E = 16 and top-2: the
last E hidden dims carry each token's code (its two experts at levels 2
and 1 times ``1/64``), every matrix that writes the residual stream
(attention's ``wo``, the Mamba ``out_proj``, the dense and expert down
projections) has zero columns there, and layer ``l``'s router reads only
those dims, as a permutation of the experts times 32.  A token's top-2
and their order follow from its code by a margin of one level, whatever
the rounding of the rest.
"""
from __future__ import annotations

import math

import torch

from portbench.inputs.lm import CODE_UNIT, ROUTER_GAIN

#: the published Mamba init's range of dt
DT_MIN, DT_MAX = 1e-3, 1e-1


def layer_kinds(cfg: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of each layer, from the offset and period keys as the
    Jamba modelling code reads them: ``attn`` / ``mamba``, ``moe`` /
    ``dense``."""
    return [("attn" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
             else "mamba",
             "moe" if i % cfg["expert_layer_period"]
             == cfg["expert_layer_offset"] else "dense")
            for i in range(cfg["num_hidden_layers"])]


def counts(cfg: dict) -> dict:
    """Layers of each kind: ``attn``, ``mamba``, ``dense``, ``moe``."""
    out = dict.fromkeys(("attn", "mamba", "dense", "moe"), 0)
    for mixer, ffn in layer_kinds(cfg):
        out[mixer] += 1
        out[ffn] += 1
    return out


def shapes(cfg: dict) -> dict:
    """The raw tree's leaves: name -> (shape, dtype, std); std None for
    ones, or the name of a special init (``a_log``, ``dt_bias``)."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    di = cfg["mamba_expand"] * d
    n, r, dc = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    f = cfg["intermediate_size"]
    e, eh = cfg["published_num_experts"], cfg["num_experts"]
    c = counts(cfg)
    na, nm, nd, ne = c["attn"], c["mamba"], c["dense"], c["moe"]
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "embed": ((v, d), bf, 0.02), "final_norm": ((d,), f32, None),
        "lm_head": ((d, v), bf, 1 / math.sqrt(d)),
        "attn.norm": ((na, d), f32, None),
        "attn.wq": ((na, d, h * dh), bf, 1 / math.sqrt(d)),
        "attn.wk": ((na, d, kv * dh), bf, 1 / math.sqrt(d)),
        "attn.wv": ((na, d, kv * dh), bf, 1 / math.sqrt(d)),
        "attn.wo": ((na, h * dh, d), bf, 1 / math.sqrt(h * dh)),
        "mamba.norm": ((nm, d), f32, None),
        "mamba.w_in": ((nm, d, 2 * di), bf, 1 / math.sqrt(d)),
        "mamba.conv_w": ((nm, dc, di), f32, 1 / math.sqrt(dc)),
        "mamba.conv_b": ((nm, di), f32, 1 / math.sqrt(dc)),
        "mamba.w_x": ((nm, di, r + 2 * n), bf, 1 / math.sqrt(di)),
        "mamba.dt_norm": ((nm, r), f32, None),
        "mamba.b_norm": ((nm, n), f32, None),
        "mamba.c_norm": ((nm, n), f32, None),
        "mamba.w_dt": ((nm, r, di), f32, 1 / math.sqrt(r)),
        "mamba.dt_b": ((nm, di), f32, "dt_bias"),
        "mamba.a_log": ((nm, di, n), f32, "a_log"),
        "mamba.d_skip": ((nm, di), f32, None),
        "mamba.w_out": ((nm, di, d), bf, 1 / math.sqrt(di)),
        "dense.norm": ((nd, d), f32, None),
        "dense.w_gate": ((nd, d, f), bf, 1 / math.sqrt(d)),
        "dense.w_up": ((nd, d, f), bf, 1 / math.sqrt(d)),
        "dense.w_down": ((nd, f, d), bf, 1 / math.sqrt(f)),
        "moe.norm": ((ne, d), f32, None),
        "moe.router": ((ne, d, e), f32, 0.0),
        "moe.e_gate": ((ne, eh, d, f), bf, 1 / math.sqrt(d)),
        "moe.e_up": ((ne, eh, d, f), bf, 1 / math.sqrt(d)),
        "moe.e_down": ((ne, eh, f, d), bf, 1 / math.sqrt(f)),
    }


#: the leaves that write the residual stream (their last dim is hidden)
WRITERS = ("attn.wo", "mamba.w_out", "dense.w_down", "moe.e_down")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The raw tree (flat: ``name -> tensor``) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = {}
    for name, (shape, dtype, std) in shapes(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        if std is None:
            t.fill_(1.0)
        elif std == 0.0:
            t.zero_()
        elif std == "a_log":
            t.copy_(torch.log(torch.arange(
                1, shape[-1] + 1, dtype=dtype, device=device)))
        elif std == "dt_bias":
            t.uniform_(math.log(DT_MIN), math.log(DT_MAX), generator=gen)
            t.exp_()
            t.add_(torch.log(-torch.expm1(-t)))
        else:
            t.normal_(0.0, std, generator=gen)
        raw[name] = t
    e = cfg["published_num_experts"]
    k = cfg["num_experts_per_tok"]
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    for name in WRITERS:
        raw[name][..., d - e:] = 0
    # each token's code: k distinct experts at levels k..1
    order = torch.rand((v, e), generator=gen, device=device).argsort(dim=1)
    code = torch.zeros((v, e), dtype=torch.float32, device=device)
    levels = torch.arange(k, 0, -1, dtype=torch.float32, device=device)
    code.scatter_(1, order[:, :k], levels.expand(v, k).contiguous())
    raw["embed"][:, d - e:] = (code * CODE_UNIT).to(raw["embed"].dtype)
    # layer l's router: hidden dim d - e + i -> expert perm_l[i]
    router = raw["moe.router"]
    for layer in range(router.shape[0]):
        perm = torch.randperm(e, generator=gen, device=device)
        router[layer, d - e + torch.arange(e, device=device), perm] = \
            ROUTER_GAIN
    return raw
