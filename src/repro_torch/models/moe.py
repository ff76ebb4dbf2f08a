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

Over the shards of a slot pool (the LM engine on a mesh) the dropping
dispatch ranks every row of a decode tick in one global order, so
:func:`apply_moe_gathered` copies each shard's rows to every device and
runs :func:`apply_moe` there on all of them in pool order: each device
keeps its shards' block, at the reference's global capacity.

``impl="auto"`` takes the reference's rule: ``grouped`` when a policy
sets a DP axis and the expert bank over TP is at most
``GROUPED_BANK_BYTES``, else ``dropping`` (with no policy, which is how
the engine and the trainer run, always ``dropping``).  On DTensors under
a policy each device routes and dispatches its own tokens
(:func:`_apply_moe_sharded`).  ``FORCE_IMPL`` (read at call time) forces
one dispatch everywhere.  The auxiliary load-balance loss is Switch-style:
E * sum_e(f_e * p_e).

On the card, a local dropping dispatch that needs no gradient runs as
the four CUDA kernels of ``kernels/moe_dispatch.py`` (route through
combine, one host call) when ``moe_dispatch.engages`` says the call fits
them; training, autograd, DTensors, the other dispatches and oversized
batches keep the code below.

Spans (``obs.span``, recorded when a caller's span is open): ``moe.route``,
then in the capacity dispatches ``moe.dispatch``, ``moe.experts``,
``moe.combine``, and ``moe.shared`` (the kernels: ``moe.fused``, then
``moe.shared``).  :func:`expert_tally` collects each capacity dispatch's
per-expert assignment counts for the LM engine's counters, and how many
of them the kernels ran.

Expert parallelism, one rank's share (``held=(lo, hi)``): the layer's
router keeps all E experts (its published width) and its expert stacks
only the ``hi - lo`` experts this device holds.  Routing, positions and
the capacity C = max(1, int(N*K/E * cf)) count all E, as in the whole
deployment; :func:`dispatch_dropping` then places only the (token, slot)
pairs that land on held experts, and the layer's output is their part
of the result (what the other ranks' experts add is theirs).  The other
dispatches need every expert and refuse a share.  ``renorm=False`` keeps
the top-k softmax probabilities as the gates (Jamba's router); the
default renormalises them to sum to 1.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading

import torch

from repro_torch.kernels import moe_dispatch
from repro_torch.launch.mesh import current
from repro_torch.models import layers
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.obs import span
from repro_torch.sharding import act

#: expert banks smaller than this (bytes, at bf16 after TP) dispatch with
#: the grouped local-capacity scheme: no cross-shard token movement
GROUPED_BANK_BYTES = 4e9

#: test hook: force one dispatch ('dense', 'grouped' or 'dropping')
#: everywhere; capacity dropping depends on the batch's composition by
#: design, so the dropping paths are not prefill/decode-consistent
FORCE_IMPL: str | None = None

#: this thread's open ``expert_tally`` list (``entries``), if any
_tally = threading.local()


class Tally(list):
    """An open tally's entries; ``fused`` counts the dispatches among them
    that ran as ``kernels/moe_dispatch.py``'s kernels."""
    fused = 0


@contextlib.contextmanager
def expert_tally():
    """Collect, on this thread, each capacity dispatch's per-expert
    assignment counts while open: -> a :class:`Tally` that gains one
    ``(counts, capacity, held)`` entry a dispatch, ``counts`` the (..., E)
    int64 device tensor that :func:`_positions` (or the kernels) compute
    anyway (kept, not copied: no kernel, no host sync), ``capacity`` C and
    ``held`` the experts [lo, hi) whose buckets it computes.  The LM engine
    opens one around a decode tick and reads it with the tick's tokens."""
    prev = getattr(_tally, "entries", None)
    _tally.entries = entries = Tally()
    try:
        yield entries
    finally:
        _tally.entries = prev


@contextlib.contextmanager
def _tally_paused():
    """No tally inside (the gathered dispatch's later devices repeat the
    first one's rows)."""
    prev = getattr(_tally, "entries", None)
    _tally.entries = None
    try:
        yield
    finally:
        _tally.entries = prev


def note_fused(entry: tuple) -> None:
    """An open tally's record of a dispatch run by the kernels: it gains
    ``entry``, the kernels' ``(counts, capacity, held)``, and counts one
    fused dispatch."""
    entries = getattr(_tally, "entries", None)
    if entries is not None:
        entries.append(entry)
        entries.fused += 1


def init_moe(generator, d_model: int, d_expert: int, n_experts: int,
             n_shared: int = 0, d_shared: int | None = None, *, device,
             lead=(), n_held: int | None = None) -> dict:
    """A float32 router (d_model, E), the expert stacks ``wi_gate`` /
    ``wi_up`` (E_held, d_model, d_expert) and ``wo`` (E_held, d_expert,
    d_model) in bf16 (``n_held`` experts, default all E), and the
    optional shared SwiGLU of width ``d_shared`` (default ``d_expert *
    n_shared``)."""
    lead = tuple(lead)
    n_held = n_experts if n_held is None else n_held
    p = {
        "router": layers.dense_init(generator, d_model, n_experts,
                                    device=device, lead=lead,
                                    dtype=torch.float32),
        "wi_gate": layers.dense_init(generator, d_model, d_expert,
                                     device=device, lead=(*lead, n_held)),
        "wi_up": layers.dense_init(generator, d_model, d_expert,
                                   device=device, lead=(*lead, n_held)),
        "wo": layers.dense_init(generator, d_expert, d_model, device=device,
                                lead=(*lead, n_held)),
    }
    if n_shared:
        ds = d_shared or d_expert * n_shared
        p["shared"] = layers.init_mlp(generator, d_model, ds, device=device,
                                      lead=lead)
    return p


def _route_stats(p: dict, x: torch.Tensor, top_k: int, renorm: bool = True):
    """-> gates, experts, and the aux loss's two means over the tokens:
    the routed fraction and the mean probability per expert.  The gates
    are the top-k probabilities, renormalised to sum to 1 with
    ``renorm``."""
    b, s, d = x.shape
    n = b * s
    logits = x.reshape(n, d).to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    if renorm:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    e = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(gate_idx, e).to(torch.float32)
    frac = onehot.sum(dim=1).mean(dim=0) / top_k
    imp = probs.mean(dim=0)
    return gate_vals, gate_idx, frac, imp


def route(p: dict, x: torch.Tensor, top_k: int, renorm: bool = True):
    """(B,S,D) -> gates (N,K) float32, experts (N,K) int64, aux loss;
    N = B*S.  Ties in the top-k keep the lower expert first, as
    ``jax.lax.top_k`` does (a stable descending sort)."""
    gate_vals, gate_idx, frac, imp = _route_stats(p, x, top_k, renorm)
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


def _positions(idx: torch.Tensor, e: int, cap: int,
               held: tuple[int, int] | None = None):
    """Position-in-expert of each (token, slot), slot-major so that
    earlier slots win capacity; idx (..., N, K) over groups of N tokens.
    -> (positions clamped to 0 where dropped, keep masks), one per slot.
    An open tally gains ``(counts, cap, held)``, ``held`` the experts
    [lo, hi) whose buckets the dispatch computes (default all E)."""
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
    entries = getattr(_tally, "entries", None)
    if entries is not None:
        entries.append((counts, cap, held or (0, e)))
    return pos_list, keep_list


def _shared(p: dict, x: torch.Tensor, out: torch.Tensor, quant_mode: str):
    if "shared" in p:
        with span("moe.shared"):
            out = out + layers.apply_mlp(p["shared"], x,
                                         quant_mode).to(x.dtype)
    return out


def _share(p: dict, held: tuple[int, int] | None) -> tuple[int, int] | None:
    """The held experts [lo, hi) (default all E the router routes to) as
    a strict share of them, or None when the layer holds them all; raises
    unless the expert stacks hold ``hi - lo`` experts."""
    e = p["router"].shape[-1]
    lo, hi = held if held is not None else (0, e)
    n_held = p["wi_gate"].shape[-3]
    if not 0 <= lo < hi <= e or hi - lo != n_held:
        raise ValueError(f"experts [{lo}, {hi}) of {e} held, the stacks "
                         f"hold {n_held}")
    return None if (lo, hi) == (0, e) else (lo, hi)


def dispatch_dropping(p: dict, x: torch.Tensor, gate_vals: torch.Tensor,
                      gate_idx: torch.Tensor, *, quant_mode: str = "none",
                      capacity_factor: float = 1.25,
                      held: tuple[int, int] | None = None) -> torch.Tensor:
    """x (B,S,D) on the given routing -> (B,S,D): the static-capacity
    dispatch.  A dropped (token, slot) adds zeros at its expert's row 0,
    which leaves the row as it is (bf16 ``index_put_`` accumulate).
    With a share ``held=(lo, hi)`` of the E experts the buckets are the
    held experts' only: a pair on another expert is dropped here, as one
    past capacity is, and the output is the held experts' part."""
    b, s, d = x.shape
    n = b * s
    top_k = gate_idx.shape[-1]
    e = p["router"].shape[-1]
    share = _share(p, held)
    xf = x.reshape(n, d)
    cap = max(1, int(n * top_k / e * capacity_factor))
    with span("moe.dispatch"):
        pos_list, keep_list = _positions(gate_idx, e, cap, share)
        if share is None:
            rows = [gate_idx[:, k] for k in range(top_k)]
        else:
            lo, hi = share
            local = [(gate_idx[:, k] >= lo) & (gate_idx[:, k] < hi)
                     for k in range(top_k)]
            keep_list = [kp & loc for kp, loc in zip(keep_list, local)]
            rows = [torch.where(loc, gate_idx[:, k] - lo, 0)
                    for k, loc in enumerate(local)]
        xe = torch.zeros((p["wi_gate"].shape[-3], cap, d),
                         dtype=COMPUTE_DTYPE, device=x.device)
        for k in range(top_k):
            contrib = (xf * keep_list[k][:, None]).to(COMPUTE_DTYPE)
            xe.index_put_((rows[k], pos_list[k]), contrib, accumulate=True)

    with span("moe.experts"):
        he = _expert_mlp(p, xe, quant_mode)

    with span("moe.combine"):
        out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        for k in range(top_k):
            yk = he[rows[k], pos_list[k]].to(torch.float32)
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
    _share(p, None)     # every expert held, or raise
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
    with span("moe.dispatch"):
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

    with span("moe.experts"):
        he = _swiglu(xe, p["wi_gate"], p["wi_up"], p["wo"], "gecd,edf->gecf")
        he = act.constrain(he, "dp", None, None, None)

    with span("moe.combine"):
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
    _share(p, None)     # every expert held, or raise
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
              impl: str = "auto", held: tuple[int, int] | None = None,
              renorm: bool = True):
    """x (B,S,D) -> (out, aux_loss).  ``auto``: ``grouped`` at the DP
    size when a policy sets a DP axis and the bank over TP is at most
    ``GROUPED_BANK_BYTES``, else ``dropping``.  A share ``held`` of the
    experts runs only the ``dropping`` dispatch, on local tensors;
    ``renorm=False`` keeps the top-k probabilities as the gates.  A local
    ``dropping`` call that ``moe_dispatch.engages`` takes runs as its
    kernels."""
    if FORCE_IMPL is not None:
        impl = FORCE_IMPL
    dp = act.axis_size("dp")
    if impl == "auto":
        e_, d_, f_ = p["wi_gate"].shape[-3:]
        bank = 3 * e_ * d_ * f_ * 2 / max(act.axis_size("tp") or 1, 1)
        impl = "grouped" if (dp and bank <= GROUPED_BANK_BYTES) \
            else "dropping"
    if _share(p, held) is not None and (impl != "dropping"
                                        or act.sharded(x)):
        raise ValueError(f"experts {held} of {p['router'].shape[-1]}: a "
                         f"share runs the dropping dispatch on local "
                         f"tensors, not {impl!r}")
    if act.sharded(x):
        if not renorm:
            raise ValueError("the sharded MoE renormalises its gates")
        return _apply_moe_sharded(p, x, top_k=top_k, quant_mode=quant_mode,
                                  capacity_factor=capacity_factor,
                                  impl=impl)
    if impl == "dropping" and moe_dispatch.engages(p, x, top_k,
                                                   capacity_factor):
        return moe_dispatch.moe_dispatch(
            p, x, top_k=top_k, quant_mode=quant_mode,
            capacity_factor=capacity_factor, held=held, renorm=renorm)
    with span("moe.route"):
        gate_vals, gate_idx, aux = (route(p, x, top_k) if renorm else
                                    route(p, x, top_k, renorm=False))
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
                                capacity_factor=capacity_factor, held=held)
    else:
        raise ValueError(f"unknown MoE dispatch {impl!r}")
    return out, aux


def apply_moe_gathered(ps: list, xs: list, *, top_k: int,
                       quant_mode: str = "none",
                       capacity_factor: float = 1.25,
                       held: tuple[int, int] | None = None,
                       renorm: bool = True) -> list:
    """The MoE over the rows of S shards, as one batch in shard order.

    ``xs[s]`` is shard ``s``'s rows (n_s, 1, D) on its device and
    ``ps[s]`` the layer's params there.  Each distinct device gathers
    every shard's rows (a copy from each other device, ordered after the
    work queued there), runs :func:`apply_moe` on all N of them and keeps
    the blocks of its own shards, so that the routing, the positions and
    the capacity ``max(1, int(N*K/E*cf))`` are the whole batch's.  ->
    each shard's output, on its device.  ``held`` and ``renorm`` as in
    :func:`apply_moe`."""
    kw = dict(top_k=top_k, quant_mode=quant_mode,
              capacity_factor=capacity_factor, held=held, renorm=renorm)
    if len(xs) == 1:
        return [apply_moe(ps[0], xs[0], **kw)[0]]
    ends = list(itertools.accumulate(x.shape[0] for x in xs))
    outs: dict = {}
    for s, x in enumerate(xs):
        if x.device not in outs:
            # an expert tally counts the rows once, on the first device
            with current(x.device), (
                    _tally_paused() if outs else contextlib.nullcontext()):
                rows = torch.cat([t.to(x.device) for t in xs])
                outs[x.device] = apply_moe(ps[s], rows, **kw)[0]
    return [outs[x.device][end - x.shape[0]:end]
            for x, end in zip(xs, ends)]
