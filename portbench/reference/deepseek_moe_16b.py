"""Plain reference of a DeepSeek-MoE decoder, from its config file.

Written from the published description and ``configs/deepseek_moe_16b.json``
alone; it imports nothing of the program and reads only the weights the
benchmark made (``inputs/lm.py``'s tree).  Float32 throughout, TF32 off,
one layer at a time: each layer's weights are upcast when the layer runs,
so the reference fits beside the bf16 weights on the card.

The decoder: token embedding; per layer a pre-norm (RMSNorm, eps from the
config) attention with rotary positions (interleaved pairs, theta from the
config) over every earlier position, and a pre-norm FFN: a SwiGLU in the
leading dense layers, else the MoE: a float32 softmax router, the top-k
experts by a stable descending sort, their gates renormalised to sum to
1 (``norm_topk_prob``), a SwiGLU per routed expert and the shared experts
as one SwiGLU of ``n_shared * moe_intermediate_size``; a final RMSNorm and
the head.

Served as the program serves it: a prompt is prefilled one token at a
time alone, and then every decode tick runs one token of each of the
``B`` sequences as one batch.  The routed experts have a capacity of
``max(1, int(rows * k / E * capacity_factor))`` (token, slot) pairs a
batch, filled slot by slot (every token's first choice before any
second), rows in batch order; a pair past its expert's capacity adds
nothing.  A prefill token alone keeps all its k (distinct) experts.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """The control's weights: float8 e4m3 with one scale per output
    column (the input dim is -2)."""
    scale = (w.abs().amax(dim=-2, keepdim=True) / FP8_MAX).clamp_min(1e-30)
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _w(raw: dict, name: str, i=None, quant: str | None = None):
    t = raw[name] if i is None else raw[name][i]
    t = t.to(torch.float32)
    if quant == "fp8" and raw[name].dtype == torch.bfloat16:
        t = _fp8(t)
    return t


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, P, H, Dh), positions 0..P-1; rotates pairs (0::2, 1::2)."""
    p, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(p, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def _swiglu(x, g, u, d):
    return (torch.nn.functional.silu(x @ g) * (x @ u)) @ d


def _keep(idx: torch.Tensor, prompt_len: int, n_experts: int,
          cf: float) -> torch.Tensor:
    """(B, P, K) expert choices -> (B, P, K) kept pairs: prefill positions
    keep all; each decode position is one batch of B rows."""
    b, p, k = idx.shape
    keep = torch.ones_like(idx, dtype=torch.bool)
    if p <= prompt_len:
        return keep
    cap = max(1, int(b * k / n_experts * cf))
    dec = idx[:, prompt_len:].transpose(0, 1)            # (Pd, B, K)
    counts = torch.zeros((dec.shape[0], n_experts), dtype=torch.int64,
                         device=idx.device)
    kept = []
    for s in range(k):
        onehot = torch.nn.functional.one_hot(dec[..., s], n_experts)
        before = torch.cumsum(onehot, dim=1) - onehot    # earlier rows
        pos = torch.gather(before + counts[:, None], -1,
                           dec[..., s:s + 1])[..., 0]
        counts = counts + onehot.sum(1)
        kept.append(pos < cap)
    keep[:, prompt_len:] = torch.stack(kept, -1).transpose(0, 1)
    return keep


def _moe(raw, i, x, cfg, prompt_len, cf, quant):
    b, p, d = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ _w(raw, "moe.router", i), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :k] / (vals[..., :k].sum(-1, keepdim=True) + 1e-9)
    idx = idx[..., :k]
    keep = _keep(idx, prompt_len, e, cf)
    flat = x.reshape(-1, d)
    out = torch.zeros_like(flat)
    tok = torch.arange(b * p, device=x.device)[:, None].expand(-1, k)
    idx_f, keep_f = idx.reshape(-1, k), keep.reshape(-1, k)
    gates_f = gates.reshape(-1, k)
    g_all = _w(raw, "moe.e_gate", i, quant)
    u_all = _w(raw, "moe.e_up", i, quant)
    d_all = _w(raw, "moe.e_down", i, quant)
    for ex in range(e):
        sel = (idx_f == ex) & keep_f
        if not bool(sel.any()):
            continue
        t = tok[sel]
        y = _swiglu(flat[t], g_all[ex], u_all[ex], d_all[ex])
        out.index_add_(0, t, y * gates_f[sel][:, None])
    out = out + _swiglu(flat, _w(raw, "moe.s_gate", i, quant),
                        _w(raw, "moe.s_up", i, quant),
                        _w(raw, "moe.s_down", i, quant))
    return out.reshape(b, p, d)


def hidden(raw: dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
           capacity_factor: float, quant: str | None = None
           ) -> torch.Tensor:
    """Final normed hidden states (B, P, D) float32 of the sequences
    ``tokens`` (B, P), teacher-forced, rows in batch order."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _hidden(raw, cfg, tokens, prompt_len, capacity_factor, quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _hidden(raw, cfg, tokens, prompt_len, cf, quant):
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    h = cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"]
    d = cfg["hidden_size"]
    dh = d // h
    nd = cfg["first_k_dense_replace"]
    b, p = tokens.shape
    x = _w(raw, "embed", quant=quant)[tokens]
    causal = torch.ones((p, p), dtype=torch.bool,
                        device=x.device).tril()
    for layer in range(cfg["num_hidden_layers"]):
        part, i = ("dense", layer) if layer < nd else ("moe", layer - nd)
        a = _rms(x, _w(raw, f"{part}.attn_norm", i), eps)
        q = _rope((a @ _w(raw, f"{part}.wq", i, quant)).view(b, p, h, dh),
                  theta)
        kk = _rope((a @ _w(raw, f"{part}.wk", i, quant)).view(b, p, kv, dh),
                   theta)
        v = (a @ _w(raw, f"{part}.wv", i, quant)).view(b, p, kv, dh)
        kk = kk.repeat_interleave(h // kv, 2)
        v = v.repeat_interleave(h // kv, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + o.reshape(b, p, h * dh) @ _w(raw, f"{part}.wo", i, quant)
        a = _rms(x, _w(raw, f"{part}.mlp_norm", i), eps)
        if part == "dense":
            x = x + _swiglu(a, _w(raw, "dense.w_gate", i, quant),
                            _w(raw, "dense.w_up", i, quant),
                            _w(raw, "dense.w_down", i, quant))
        else:
            x = x + _moe(raw, i, a, cfg, prompt_len, cf, quant)
    return _rms(x, _w(raw, "final_norm"), eps)


def gaps(raw: dict, cfg: dict, h_ref: torch.Tensor, served: torch.Tensor,
         start: int, h_alt: torch.Tensor | None = None,
         quant: str | None = None, chunk: int = 64) -> dict:
    """By how much each served token's logit lies below the reference's
    best, at positions ``start ..`` of ``h_ref`` (B, P, D), served tokens
    ``served`` (B, n) -> ``{"max_gap", "mean_gap", "argmax_differs",
    "positions"}``.  With ``h_alt`` (the control's hidden states, head
    in ``quant``) the token the control puts first takes the served
    token's place."""
    b, n = served.shape
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        head = _w(raw, "lm_head")
        alt_head = _w(raw, "lm_head", quant=quant) if h_alt is not None \
            else None
        worst, total, differs = 0.0, 0.0, 0
        for c0 in range(0, n, chunk):
            c1 = min(n, c0 + chunk)
            lg = h_ref[:, start + c0:start + c1] @ head      # (B, c, V)
            best = lg.max(-1).values
            if h_alt is None:
                pick = served[:, c0:c1].long()
            else:
                pick = (h_alt[:, start + c0:start + c1] @ alt_head).argmax(-1)
            got = torch.gather(lg, -1, pick[..., None])[..., 0]
            gap = best - got
            worst = max(worst, float(gap.max()))
            total += float(gap.sum())
            differs += int((lg.argmax(-1) != pick).sum())
            del lg
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"max_gap": worst, "mean_gap": total / (b * n),
            "argmax_differs": differs, "positions": b * n}
