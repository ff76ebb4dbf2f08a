"""Plain reference of a Jamba decoder, from its config file.

Written from the published Jamba description (arXiv:2403.19887), its
modelling code's equations and ``configs/jamba2_mini.json`` alone; it
imports nothing of the program and reads only the weights the benchmark
made (``inputs/jamba.py``'s tree).  Float32 throughout, TF32 off, one
layer at a time: each layer's weights are upcast when the layer runs (an
MoE layer's expert by expert), so the reference fits beside the bf16
weights on the card.

The decoder: token embedding, no positional encoding; per layer a
pre-norm (RMSNorm, eps from the config) mixer and a pre-norm FFN, each
added to the residual stream; a final RMSNorm and the head.  Layer ``i``
mixes by attention when ``i % attn_layer_period == attn_layer_offset``,
else by Mamba; its FFN is the MoE when ``i % expert_layer_period ==
expert_layer_offset``, else a SwiGLU of ``intermediate_size``.

* Attention: grouped-query, no RoPE, no biases, softmax of q k^T /
  sqrt(d_head) over every earlier position.
* Mamba (the published Jamba mixer): ``x, z = in_proj(h)``; ``x =
  silu(conv1d(x) + conv_b)``, causal and depthwise over ``d_conv`` taps;
  ``dt_r, B, C = x_proj(x)``, each RMS-normalised (gains ``dt_norm``,
  ``b_norm``, ``c_norm``); ``dt = softplus(dt_proj(dt_r) + dt_b)``; the
  selective scan ``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t`` from zero,
  ``A = -exp(A_log)``, ``y_t = s_t C_t + D x_t``; ``out_proj(y *
  silu(z))``.
* MoE: a float32 softmax router over all ``published_num_experts``, the
  top-k by a stable descending sort, gates the top-k probabilities (not
  renormalised), a SwiGLU per expert of ``intermediate_size``.

Departures, each the benchmark's stated deployment (``assumed`` in the
config file): this card's share of the experts.  Only the experts
``experts_held`` [lo, hi) add to an MoE layer's output; what the others
would add is left out, as it is in the program.  Served as the program
serves it: a prompt is prefilled one token at a time alone, and then
every decode tick runs one token of each of the ``B`` sequences as one
batch.  The experts have a capacity of ``max(1, int(rows * k / E *
capacity_factor))`` (token, slot) pairs a batch over all E experts,
filled slot by slot (every token's first choice before any second), rows
in batch order; a pair past its expert's capacity adds nothing.  A
prefill token alone keeps all its k (distinct) experts.  The Mamba scan
runs position by position.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _swiglu(x, g, u, d):
    return (F.silu(x @ g) * (x @ u)) @ d


def _layers(cfg: dict) -> list[tuple[str, int, str, int]]:
    """(mixer, its index among its kind, ffn, its index) per layer."""
    seen = dict.fromkeys(("attn", "mamba", "dense", "moe"), 0)
    out = []
    for i in range(cfg["num_hidden_layers"]):
        mixer = "attn" if i % cfg["attn_layer_period"] == \
            cfg["attn_layer_offset"] else "mamba"
        ffn = "moe" if i % cfg["expert_layer_period"] == \
            cfg["expert_layer_offset"] else "dense"
        out.append((mixer, seen[mixer], ffn, seen[ffn]))
        seen[mixer] += 1
        seen[ffn] += 1
    return out


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
        onehot = F.one_hot(dec[..., s], n_experts)
        before = torch.cumsum(onehot, dim=1) - onehot    # earlier rows
        pos = torch.gather(before + counts[:, None], -1,
                           dec[..., s:s + 1])[..., 0]
        counts = counts + onehot.sum(1)
        kept.append(pos < cap)
    keep[:, prompt_len:] = torch.stack(kept, -1).transpose(0, 1)
    return keep


def _attention(raw, i, a, cfg, quant):
    b, p, d = a.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    q = (a @ _w(raw, "attn.wq", i, quant)).view(b, p, h, dh)
    k = (a @ _w(raw, "attn.wk", i, quant)).view(b, p, kv, dh)
    v = (a @ _w(raw, "attn.wv", i, quant)).view(b, p, kv, dh)
    k = k.repeat_interleave(h // kv, 2)
    v = v.repeat_interleave(h // kv, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    causal = torch.ones((p, p), dtype=torch.bool, device=a.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return o.reshape(b, p, h * dh) @ _w(raw, "attn.wo", i, quant)


def _mamba(raw, i, a, cfg, quant):
    b, p, d = a.shape
    di = cfg["mamba_expand"] * d
    n, r, dc = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    eps = cfg["rms_norm_eps"]
    xz = a @ _w(raw, "mamba.w_in", i, quant)
    x, z = xz[..., :di], xz[..., di:]
    del xz
    xpad = F.pad(x, (0, 0, dc - 1, 0))
    conv_w = _w(raw, "mamba.conv_w", i)
    conv = _w(raw, "mamba.conv_b", i).expand(b, p, di).clone()
    for t in range(dc):
        conv += xpad[:, t:t + p] * conv_w[t]
    del xpad
    x = F.silu(conv)
    del conv
    proj = x @ _w(raw, "mamba.w_x", i, quant)
    dt_r = _rms(proj[..., :r], _w(raw, "mamba.dt_norm", i), eps)
    bb = _rms(proj[..., r:r + n], _w(raw, "mamba.b_norm", i), eps)
    cc = _rms(proj[..., r + n:], _w(raw, "mamba.c_norm", i), eps)
    dt = F.softplus(dt_r @ _w(raw, "mamba.w_dt", i)
                    + _w(raw, "mamba.dt_b", i))
    a_mat = -torch.exp(_w(raw, "mamba.a_log", i))               # (Di, N)
    dtx = dt * x
    state = torch.zeros((b, di, n), dtype=torch.float32, device=a.device)
    y = torch.empty((b, p, di), dtype=torch.float32, device=a.device)
    for t in range(p):
        state = torch.exp(dt[:, t, :, None] * a_mat) * state \
            + dtx[:, t, :, None] * bb[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", state, cc[:, t])
    del dt, dtx, state
    y = (y + x * _w(raw, "mamba.d_skip", i)) * F.silu(z)
    return y @ _w(raw, "mamba.w_out", i, quant)


def _moe(raw, i, x, cfg, prompt_len, cf, quant):
    b, p, d = x.shape
    e, k = cfg["published_num_experts"], cfg["num_experts_per_tok"]
    lo, hi = cfg["experts_held"]
    probs = torch.softmax(x @ _w(raw, "moe.router", i), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], idx[..., :k]
    keep = _keep(idx, prompt_len, e, cf)
    flat = x.reshape(-1, d)
    out = torch.zeros_like(flat)
    tok = torch.arange(b * p, device=x.device)[:, None].expand(-1, k)
    idx_f, keep_f = idx.reshape(-1, k), keep.reshape(-1, k)
    gates_f = gates.reshape(-1, k)
    for ex in range(lo, hi):
        sel = (idx_f == ex) & keep_f
        if not bool(sel.any()):
            continue
        t = tok[sel]
        w = [raw[f"moe.e_{part}"][i, ex - lo].to(torch.float32)
             for part in ("gate", "up", "down")]
        if quant == "fp8":
            w = [_fp8(t_) for t_ in w]
        y = _swiglu(flat[t], *w)
        out.index_add_(0, t, y * gates_f[sel][:, None])
    return out.reshape(b, p, d)


def hidden(raw: dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
           capacity_factor: float, quant: str | None = None
           ) -> torch.Tensor:
    """Final normed hidden states (B, P, D) float32 of the sequences
    ``tokens`` (B, P), teacher-forced, rows in batch order."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _hidden(raw, cfg, tokens, prompt_len, capacity_factor, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _hidden(raw, cfg, tokens, prompt_len, cf, quant):
    eps = cfg["rms_norm_eps"]
    x = _w(raw, "embed", quant=quant)[tokens]
    for mixer, j, ffn, m in _layers(cfg):
        a = _rms(x, _w(raw, f"{mixer}.norm", j), eps)
        mix = _attention if mixer == "attn" else _mamba
        x = x + mix(raw, j, a, cfg, quant)
        a = _rms(x, _w(raw, f"{ffn}.norm", m), eps)
        if ffn == "dense":
            x = x + _swiglu(a, _w(raw, "dense.w_gate", m, quant),
                            _w(raw, "dense.w_up", m, quant),
                            _w(raw, "dense.w_down", m, quant))
        else:
            x = x + _moe(raw, m, a, cfg, prompt_len, cf, quant)
        del a
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
