"""The LM cells' weights and prompts, made from the seed on the device.

``make_weights`` draws every matrix with one ``normal_`` call a stacked
leaf, in the dtype it is served in (bf16; norm gains and the router in
float32), from a ``torch.Generator`` on the device: normal with std
``1 / sqrt(fan_in)``, embeddings 0.02, norm gains 1.  The tree is the
benchmark's own (``raw``); a driver hands its tensors to the program as
views, and the reference reads them.

The router is structured so that rounding cannot change a routing: the
last ``E`` hidden dims (``E`` routed experts) carry each token's code,
six experts at levels 6..1 times ``1/64`` and 0 elsewhere, and every
matrix that writes the residual stream (attention's and the FFNs' output
projections) has zero columns there, so those dims hold the token's code
exactly through every layer.  Layer ``l``'s router reads only them, as a
permutation of the experts times 32.  A token's top-6 experts and their
order then follow from its code by a margin of one level, whatever the
rounding of the rest; the random-weight near ties that would make a
bf16 program and a float32 reference route differently do not arise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CODE_UNIT = 1.0 / 64
ROUTER_GAIN = 32.0


def shapes(cfg: dict) -> dict:
    """The raw tree's leaves: name -> (shape, dtype, std or None for
    ones); ``dense.*`` stacked over the leading dense layers, ``moe.*``
    over the MoE layers."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    nd = cfg["first_k_dense_replace"]
    nm = cfg["num_hidden_layers"] - nd
    e, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = fe * cfg["n_shared_experts"]
    f = cfg["intermediate_size"]
    bf, f32 = torch.bfloat16, torch.float32
    s = {"embed": ((v, d), bf, 0.02), "final_norm": ((d,), f32, None),
         "lm_head": ((d, v), bf, 1 / math.sqrt(d))}
    for part, n in (("dense", nd), ("moe", nm)):
        s.update({
            f"{part}.attn_norm": ((n, d), f32, None),
            f"{part}.wq": ((n, d, h * dh), bf, 1 / math.sqrt(d)),
            f"{part}.wk": ((n, d, kv * dh), bf, 1 / math.sqrt(d)),
            f"{part}.wv": ((n, d, kv * dh), bf, 1 / math.sqrt(d)),
            f"{part}.wo": ((n, h * dh, d), bf, 1 / math.sqrt(h * dh)),
            f"{part}.mlp_norm": ((n, d), f32, None)})
    s.update({
        "dense.w_gate": ((nd, d, f), bf, 1 / math.sqrt(d)),
        "dense.w_up": ((nd, d, f), bf, 1 / math.sqrt(d)),
        "dense.w_down": ((nd, f, d), bf, 1 / math.sqrt(f)),
        "moe.router": ((nm, d, e), f32, 0.0),
        "moe.e_gate": ((nm, e, d, fe), bf, 1 / math.sqrt(d)),
        "moe.e_up": ((nm, e, d, fe), bf, 1 / math.sqrt(d)),
        "moe.e_down": ((nm, e, fe, d), bf, 1 / math.sqrt(fe)),
        "moe.s_gate": ((nm, d, fs), bf, 1 / math.sqrt(d)),
        "moe.s_up": ((nm, d, fs), bf, 1 / math.sqrt(d)),
        "moe.s_down": ((nm, fs, d), bf, 1 / math.sqrt(fs))})
    return s


#: the leaves that write the residual stream (their last dim is hidden)
WRITERS = ("dense.wo", "dense.w_down", "moe.wo", "moe.e_down", "moe.s_down")


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
        else:
            t.normal_(0.0, std, generator=gen)
        raw[name] = t
    e = cfg["n_routed_experts"]
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


def prompts(cfg: dict, seed: int, n: int, length: int) -> np.ndarray:
    """(n, length) int32 prompt tokens, uniform over the vocabulary."""
    rng = np.random.default_rng([seed, 2])
    return rng.integers(0, cfg["vocab_size"], (n, length)).astype(np.int32)
