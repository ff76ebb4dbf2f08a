"""Mixture-of-experts blocks: fine-grained routed experts + shared experts.

The port of the reference's ``repro/models/moe.py``.  Covers the MoE
recipes of the configs:
  * deepseek-moe-16b : 64 routed (top-6) + 2 shared experts, fine-grained
  * llama4-scout     : 16 routed (top-1) + 1 shared
  * jamba-1.5-large  : 16 routed (top-2), every other layer

The router (:func:`route`) and the dispatch are separate functions, so
that a dispatch can be run on given routing.  Three dispatches, as in the
reference:
  * :func:`dispatch_dropping`: tokens-choose with a static expert
    capacity C = max(1, int(N*K/E * cf)); tokens scatter into an
    (E, C, D) buffer slot-major (earlier slots win capacity), experts run
    batched SwiGLUs on their buckets, results gather back gate-weighted
    in float32.  Every expert's weights are read, whatever the routing.
  * :func:`dispatch_grouped`: the same with positions counted within
    ``groups`` contiguous groups of tokens, and the buckets gathered
    through an int32 slot -> token table.  Under a sharding policy
    (``sharding.act``) the group count is the DP size, so that no token
    leaves its shard; the caller may pass it (default 1).
  * :func:`dispatch_dense`: every expert on every token, masked by the
    combine weights; exact (no dropping), the tests' reference.

``impl="auto"`` takes the reference's rule: ``grouped`` when a policy
sets a DP axis and the expert bank over TP is at most
``GROUPED_BANK_BYTES``, else ``dropping`` (with no policy, which is how
the engine and the trainer run, always ``dropping``).  On DTensors under
a policy each device routes and dispatches its own tokens
(:func:`_apply_moe_sharded`).  ``FORCE_IMPL`` (read at call time) forces
one dispatch everywhere.  The auxiliary load-balance loss is Switch-style:
E * sum_e(f_e * p_e).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.sharding import act

#: expert banks smaller than this (bytes, at bf16 after TP) dispatch with
#: the grouped local-capacity scheme: no cross-shard token movement
GROUPED_BANK_BYTES = 4e9

#: test hook: force one dispatch ('dense', 'grouped' or 'dropping')
#: everywhere; capacity dropping depends on the batch's composition by
#: design, so the dropping paths are not prefill/decode-consistent
FORCE_IMPL: str | None = None


def init_moe(generator, d_model: int, d_expert: int, n_experts: int,
             n_shared: int = 0, d_shared: int | None = None, *, device,
             lead=()) -> dict:
    """A float32 router (d_model, E), the expert stacks ``wi_gate`` /
    ``wi_up`` (E, d_model, d_expert) and ``wo`` (E, d_expert, d_model)
    in bf16, and the optional shared SwiGLU of width ``d_shared`` (default
    ``d_expert * n_shared``)."""
    lead = tuple(lead)
    p = {
        "router": layers.dense_init(generator, d_model, n_experts,
                                    device=device, lead=lead,
                                    dtype=torch.float32),
        "wi_gate": layers.dense_init(generator, d_model, d_expert,
                                     device=device,
                                     lead=(*lead, n_experts)),
        "wi_up": layers.dense_init(generator, d_model, d_expert,
                                   device=device, lead=(*lead, n_experts)),
        "wo": layers.dense_init(generator, d_expert, d_model, device=device,
                                lead=(*lead, n_experts)),
    }
    if n_shared:
        ds = d_shared or d_expert * n_shared
        p["shared"] = layers.init_mlp(generator, d_model, ds, device=device,
                                      lead=lead)
    return p


def _route_stats(p: dict, x: torch.Tensor, top_k: int):
    """-> gates, experts, and the aux loss's two means over the tokens:
    the routed fraction and the mean probability per expert."""
    b, s, d = x.shape
    n = b * s
    logits = x.reshape(n, d).to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    e = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(gate_idx, e).to(torch.float32)
    frac = onehot.sum(dim=1).mean(dim=0) / top_k
    imp = probs.mean(dim=0)
    return gate_vals, gate_idx, frac, imp


def route(p: dict, x: torch.Tensor, top_k: int):
    """(B,S,D) -> gates (N,K) float32, experts (N,K) int64, aux loss;
    N = B*S.  Ties in the top-k keep the lower expert first, as
    ``jax.lax.top_k`` does (a stable descending sort)."""
    gate_vals, gate_idx, frac, imp = _route_stats(p, x, top_k)
    aux = frac.shape[-1] * torch.sum(frac * imp)
    return gate_vals, gate_idx, aux


def _swiglu(xe, wi_gate, wi_up, wo, spec: str):
    """A batched SwiGLU over the expert axis: ``spec`` maps the two
    operands of each product (bf16 products, float32 accumulation)."""
    xc = xe.to(COMPUTE_DTYPE)
    g = torch.einsum(spec, xc, wi_gate.to(COMPUTE_DTYPE))
    u = torch.einsum(spec, xc, wi_up.to(COMPUTE_DTYPE))
    h = torch.nn.functional.silu(g.to(torch.float32)).to(COMPUTE_DTYPE) * u
    return torch.einsum(spec, h, wo.to(COMPUTE_DTYPE))


def _expert_mlp(p: dict, xe: torch.Tensor, quant_mode: str = "none"):
    """xe (E, C, D) -> (E, C, D): each expert's SwiGLU on its bucket.
    Experts run in bf16 whatever ``quant_mode``, as the reference's do."""
    xe = act.constrain(xe, "dp", None, None)
    out = _swiglu(xe, p["wi_gate"], p["wi_up"], p["wo"], "ecd,edf->ecf")
    return act.constrain(out, "dp", None, None)


def _positions(idx: torch.Tensor, e: int, cap: int):
    """Position-in-expert of each (token, slot), slot-major so that
    earlier slots win capacity; idx (..., N, K) over groups of N tokens.
    -> (positions clamped to 0 where dropped, keep masks), one per slot."""
    pos_list, keep_list = [], []
    counts = torch.zeros((*idx.shape[:-2], e), dtype=torch.int64,
                         device=idx.device)
    for k in range(idx.shape[-1]):
        ik = idx[..., k]                                       # (..., N)
        onehot = torch.nn.functional.one_hot(ik, e)            # (..., N, E)
        pos_within = torch.cumsum(onehot, dim=-2) - 1
        pos = torch.gather(pos_within, -1, ik[..., None])[..., 0] + \
            torch.gather(counts, -1, ik)
        counts = counts + onehot.sum(dim=-2)
        keep = pos < cap
        pos_list.append(torch.where(keep, pos, 0))
        keep_list.append(keep)
    return pos_list, keep_list


def _shared(p: dict, x: torch.Tensor, out: torch.Tensor, quant_mode: str):
    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], x, quant_mode).to(x.dtype)
    return out


def dispatch_dropping(p: dict, x: torch.Tensor, gate_vals: torch.Tensor,
                      gate_idx: torch.Tensor, *, quant_mode: str = "none",
                      capacity_factor: float = 1.25) -> torch.Tensor:
    """x (B,S,D) on the given routing -> (B,S,D): the static-capacity
    dispatch.  A dropped (token, slot) adds zeros at its expert's row 0,
    which leaves the row as it is (bf16 ``index_put_`` accumulate)."""
    b, s, d = x.shape
    n = b * s
    top_k = gate_idx.shape[-1]
    e = p["router"].shape[-1]
    xf = x.reshape(n, d)
    cap = max(1, int(n * top_k / e * capacity_factor))
    pos_list, keep_list = _positions(gate_idx, e, cap)

    xe = torch.zeros((e, cap, d), dtype=COMPUTE_DTYPE, device=x.device)
    for k in range(top_k):
        contrib = (xf * keep_list[k][:, None]).to(COMPUTE_DTYPE)
        xe.index_put_((gate_idx[:, k], pos_list[k]), contrib,
                      accumulate=True)

    he = _expert_mlp(p, xe, quant_mode)

    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for k in range(top_k):
        yk = he[gate_idx[:, k], pos_list[k]].to(torch.float32)
        out = out + yk * (gate_vals[:, k] * keep_list[k])[:, None]
    out = out.reshape(b, s, d).to(x.dtype)
    return _shared(p, x, out, quant_mode)


def dispatch_grouped(p: dict, x: torch.Tensor, gate_vals: torch.Tensor,
                     gate_idx: torch.Tensor, *, quant_mode: str = "none",
                     capacity_factor: float = 1.25,
                     groups: int = 1) -> torch.Tensor:
    """The grouped local-capacity dispatch: the N tokens as ``groups``
    contiguous groups (1 when N does not divide), positions and the
    capacity C = max(1, int(N/G*K/E * cf)) counted within each group, the
    buckets gathered through an int32 (G, E, C) slot -> token table."""
    b, s, d = x.shape
    n = b * s
    top_k = gate_idx.shape[-1]
    e = p["router"].shape[-1]
    g = groups if n % groups == 0 else 1
    ng = n // g
    xg = act.constrain(x.reshape(g, ng, d), "dp", None, None)
    idx_g = gate_idx.reshape(g, ng, top_k)
    val_g = gate_vals.reshape(g, ng, top_k)
    cap = max(1, int(ng * top_k / e * capacity_factor))
    pos_list, keep_list = _positions(idx_g, e, cap)

    # the slot -> token table by a scatter-max over the flat (G, E, C)
    # index, as the reference's ``.at[].max``
    dev = x.device
    base = torch.arange(g, device=dev)[:, None] * (e * cap)
    tok_ids = torch.arange(ng, device=dev).expand(g, ng)
    slot_tok = torch.zeros(g * e * cap, dtype=torch.int64, device=dev)
    slot_keep = torch.zeros(g * e * cap, dtype=torch.int64, device=dev)
    for k in range(top_k):
        flat = (base + idx_g[:, :, k] * cap + pos_list[k]).reshape(-1)
        kmask = keep_list[k]
        slot_tok.scatter_reduce_(0, flat, torch.where(
            kmask, tok_ids, 0).reshape(-1), reduce="amax")
        slot_keep.scatter_reduce_(0, flat, kmask.reshape(-1).long(),
                                  reduce="amax")
    slot_tok = slot_tok.reshape(g, e, cap)
    slot_keep = slot_keep.reshape(g, e, cap).bool()
    garange = torch.arange(g, device=dev)[:, None, None]
    xe = xg[garange, slot_tok].to(COMPUTE_DTYPE) * slot_keep[..., None]
    xe = act.constrain(xe, "dp", None, None, None)

    he = _swiglu(xe, p["wi_gate"], p["wi_up"], p["wo"], "gecd,edf->gecf")
    he = act.constrain(he, "dp", None, None, None)

    out = torch.zeros((g, ng, d), dtype=torch.float32, device=dev)
    gidx = torch.arange(g, device=dev)[:, None]
    for k in range(top_k):
        yk = he[gidx, idx_g[:, :, k], pos_list[k]].to(torch.float32)
        out = out + yk * (val_g[:, :, k] * keep_list[k])[..., None]
    out = out.reshape(b, s, d).to(x.dtype)
    return _shared(p, x, out, quant_mode)


def dispatch_dense(p: dict, x: torch.Tensor, gate_vals: torch.Tensor,
                   gate_idx: torch.Tensor, *,
                   quant_mode: str = "none") -> torch.Tensor:
    """Every expert on every token, combined by the gate weights: exact
    (no token dropping)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    onehot = torch.nn.functional.one_hot(gate_idx, e).to(torch.float32)
    combine = (onehot * gate_vals[..., None]).sum(dim=1).reshape(b, s, e)
    xc = x.to(COMPUTE_DTYPE)
    g = torch.einsum("bsd,edf->ebsf", xc, p["wi_gate"].to(COMPUTE_DTYPE))
    u = torch.einsum("bsd,edf->ebsf", xc, p["wi_up"].to(COMPUTE_DTYPE))
    h = torch.nn.functional.silu(g.to(torch.float32)).to(COMPUTE_DTYPE) * u
    eo = torch.einsum("ebsf,efd->ebsd", h, p["wo"].to(COMPUTE_DTYPE))
    out = torch.einsum("ebsd,bse->bsd", eo, combine.to(COMPUTE_DTYPE))
    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], xc, quant_mode)
    return out.to(x.dtype)


def _apply_moe_sharded(p: dict, x, *, top_k: int, quant_mode: str,
                       capacity_factor: float, impl: str):
    """The MoE on DTensors under a policy: each device routes its own
    tokens (the batch over DP) and runs its slice of every expert (F over
    TP: a partial sum over TP).  ``grouped``: the local tokens are one
    group, so no token moves; ``dropping`` at the local capacity, with
    experts that a bank past ``GROUPED_BANK_BYTES`` shards over an
    expert-parallel axis gathered (no config of the repo has such a
    bank at TP 16).  The aux loss comes from the routing statistics
    averaged over the shards."""
    from torch.distributed.tensor import Partial, Replicate

    pol = act.policy()
    mesh = pol["mesh"]
    names = list(act.mesh_axes(mesh))
    b = x.shape[0]
    dp = act.axis_size("dp") or 1
    b_ax = pol["dp"] if (pol["dp"] and b % dp == 0 and b >= dp) else None
    x_pl = act.spec_placements(3, b_ax)
    keys = ["router", "wi_gate", "wi_up", "wo"]
    if "shared" in p:
        keys += [f"shared/{k}" for k in ("wi_gate", "wi_up", "wo")]
    ws = [p[k] if "/" not in k else p["shared"][k.split("/")[1]]
          for k in keys]
    # each weight as the device computes with it: F over TP stays
    # sharded; any other sharding (FSDP storage, or experts over an
    # expert-parallel axis) is gathered for the layer
    keep = {"wi_gate": 2, "wi_up": 2, "wo": 1, "shared/wi_gate": 1,
            "shared/wi_up": 1, "shared/wo": 0}
    w_pl = [tuple(pl if k in keep and pl.is_shard(keep[k]) else Replicate()
                  for pl in w.placements) for k, w in zip(keys, ws)]
    # the output is a partial sum over every axis that shards F
    out_pl = list(x_pl)
    for i, pl in enumerate(w_pl[1]):
        if pl.is_shard(2):
            out_pl[i] = Partial()
    # the routing statistics are means over all the tokens, which every
    # device of a TP group computes alike: each device's mean over its
    # own tokens, divided by the count of devices the layer is split
    # over (DP and TP), is a partial sum over them, so that each
    # device's gradient is its share (the router's gradient is a
    # partial sum over both, as the experts' part of it is)
    sizes = act.mesh_axes(mesh)
    b_axes = () if not b_ax else ((b_ax,) if isinstance(b_ax, str)
                                  else tuple(b_ax))
    split = [i for i in range(len(names))
             if names[i] in b_axes or out_pl[i].is_partial()]
    n_b = math.prod(sizes[names[i]] for i in split)
    stat_pl = tuple(Partial() if i in split else Replicate()
                    for i in range(len(names)))

    def local(xl, *wl):
        lp = dict(zip(keys[:4], wl[:4]))
        if len(wl) > 4:
            lp["shared"] = dict(zip(("wi_gate", "wi_up", "wo"), wl[4:]))
        gv, gi, frac, imp = _route_stats(lp, xl, top_k)
        kw = dict(quant_mode=quant_mode, capacity_factor=capacity_factor)
        if impl == "dense":
            out = dispatch_dense(lp, xl, gv, gi, quant_mode=quant_mode)
        elif impl == "grouped":
            out = dispatch_grouped(lp, xl, gv, gi, **kw)
        else:
            out = dispatch_dropping(lp, xl, gv, gi, **kw)
        return out, frac / n_b, imp / n_b

    out, frac, imp = act.shard_map(
        local, (x, *ws), (x_pl, *w_pl), (tuple(out_pl), stat_pl, stat_pl))
    aux = frac.shape[-1] * torch.sum(frac * imp)
    return out, aux


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int,
              quant_mode: str = "none", capacity_factor: float = 1.25,
              impl: str = "auto"):
    """x (B,S,D) -> (out, aux_loss).  ``auto``: ``grouped`` at the DP
    size when a policy sets a DP axis and the bank over TP is at most
    ``GROUPED_BANK_BYTES``, else ``dropping``."""
    if FORCE_IMPL is not None:
        impl = FORCE_IMPL
    dp = act.axis_size("dp")
    if impl == "auto":
        e_, d_, f_ = p["wi_gate"].shape[-3:]
        bank = 3 * e_ * d_ * f_ * 2 / max(act.axis_size("tp") or 1, 1)
        impl = "grouped" if (dp and bank <= GROUPED_BANK_BYTES) \
            else "dropping"
    if act.sharded(x):
        return _apply_moe_sharded(p, x, top_k=top_k, quant_mode=quant_mode,
                                  capacity_factor=capacity_factor,
                                  impl=impl)
    gate_vals, gate_idx, aux = route(p, x, top_k)
    if impl == "dense":
        out = dispatch_dense(p, x, gate_vals, gate_idx,
                             quant_mode=quant_mode)
    elif impl == "grouped":
        out = dispatch_grouped(p, x, gate_vals, gate_idx,
                               quant_mode=quant_mode,
                               capacity_factor=capacity_factor,
                               groups=dp or 1)
    elif impl == "dropping":
        out = dispatch_dropping(p, x, gate_vals, gate_idx,
                                quant_mode=quant_mode,
                                capacity_factor=capacity_factor)
    else:
        raise ValueError(f"unknown MoE dispatch {impl!r}")
    return out, aux
