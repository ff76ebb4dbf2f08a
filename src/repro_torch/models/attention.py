"""Grouped-query attention with qk-norm, RoPE and a KV cache (PyTorch).

The port of the reference's ``repro/models/attention.py``.  Shapes: x
(B, S, D); q heads H, kv heads Hk (H % Hk == 0); d_head Dh.  Causal
masking is by position comparison, so the same code serves train (full
causal), prefill (causal + cache export) and decode (one query against a
cache).  The math is the reference's, in plain torch ops: scores are
float32 products of the bf16 operands (upcast, TF32 off under
``layers.lm_precision``), masked with ``-1e30``, softmaxed in float32, and
the probabilities cast to bf16 for the value product.  The reference's
sharding constraints (``sharding.act``) sit at its points and are no-ops
without a policy.  ``cross_attention`` serves the encoder-decoder
family's decoder.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.models import layers
from repro_torch.models.layers import COMPUTE_DTYPE, apply_linear, apply_rope
from repro_torch.models.scan_utils import scan
from repro_torch.sharding import act


def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   d_head: int, qk_norm: bool = False, *, device,
                   lead=()) -> dict:
    p = {
        "wq": layers.dense_init(generator, d_model, n_heads * d_head,
                                device=device, lead=lead),
        "wk": layers.dense_init(generator, d_model, n_kv_heads * d_head,
                                device=device, lead=lead),
        "wv": layers.dense_init(generator, d_model, n_kv_heads * d_head,
                                device=device, lead=lead),
        "wo": layers.dense_init(generator, n_heads * d_head, d_model,
                                device=device, lead=lead),
    }
    if qk_norm:
        p["q_norm"] = layers.ones((*lead, d_head), device)
        p["k_norm"] = layers.ones((*lead, d_head), device)
    return p


def _qkv(p, x, n_heads, n_kv_heads, d_head, positions, rope_theta,
         quant_mode):
    b, s, _ = x.shape
    q = act.reshape(apply_linear(x, p["wq"], quant_mode), b, s, n_heads,
                    d_head)
    k = act.reshape(apply_linear(x, p["wk"], quant_mode), b, s, n_kv_heads,
                    d_head)
    v = act.reshape(apply_linear(x, p["wv"], quant_mode), b, s, n_kv_heads,
                    d_head)
    if "q_norm" in p:
        q = layers.rmsnorm(q, p["q_norm"])
        k = layers.rmsnorm(k, p["k_norm"])
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


QUERY_CHUNK = 1024
KV_CHUNK = 1024


def _f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 operand upcast: its products are exact in float32, so a
    float32 matmul of the upcasts is the reference's bf16 dot with
    ``preferred_element_type=float32``."""
    return x.to(COMPUTE_DTYPE).to(torch.float32)


def _sdpa_block(q, k, v, q_pos, k_pos, causal):
    """Unchunked block: q (B,Sq,H,Dh), k/v (B,Sk,Hk,Dh).

    Under a sharding policy the logits are pinned to kv-head TP when the
    kv heads divide the axis, else to the KV sequence (sequence-parallel
    attention: k/v stay put and the softmax reduces across shards), as
    the reference pins its decode path."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    q = q.reshape(b, sq, hk, g, dh)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", _f32(q), _f32(k)) * scale
    tp = act.axis_size("tp")
    if tp and hk % tp == 0:
        logits = act.constrain(logits, "dp", "tp", None, None, None)
    else:
        logits = act.constrain(logits, "dp", None, None, None, "tp")
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]  # (Sq, Sk)
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(COMPUTE_DTYPE)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(COMPUTE_DTYPE))
    return out.reshape(b, sq, h, dh)


def _sdpa_flash(q, k, v, q_pos, k_pos, causal: bool = True,
                q_chunk: int | None = None, kv_chunk: int | None = None):
    """Online-softmax attention: never materializes (Sq, Sk) logits.  A
    loop over query chunks, an inner one over KV chunks carrying the
    running (max, denom, acc) in float32, as the reference's scans do."""
    q_chunk = q_chunk or QUERY_CHUNK
    kv_chunk = kv_chunk or KV_CHUNK
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(dh)
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, sk)
    if sq % qc:
        qc = sq
    if sk % kc:
        kc = sk
    nq, nk = sq // qc, sk // kc

    qs = torch.movedim(q.reshape(b, nq, qc, hk, g, dh), 1, 0)
    qps = q_pos.reshape(nq, qc)
    ks = torch.movedim(k.reshape(b, nk, kc, hk, dh), 1, 0)
    vs = torch.movedim(v.reshape(b, nk, kc, hk, dh), 1, 0)
    kps = k_pos.reshape(nk, kc)

    def q_step(_, xq):
        q_blk, qp = xq

        def kv_step(carry, xkv):
            m, l, acc = carry
            k_blk, v_blk, kp = xkv
            logits = torch.einsum("bqhgd,bkhd->bhgqk", _f32(q_blk),
                                  _f32(k_blk)) * scale
            if causal:
                mask = qp[:, None] >= kp[None, :]
                logits = torch.where(mask, logits, -1e30)
            m_blk = logits.amax(dim=-1)
            m_new = torch.maximum(m, m_blk)
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_new = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", _f32(p), _f32(v_blk))
            acc_new = acc * corr[..., None] + pv
            return (m_new, l_new, acc_new), None

        dev = q_blk.device
        m0 = torch.full((b, hk, g, qc), -math.inf, dtype=torch.float32,
                        device=dev)
        l0 = torch.zeros((b, hk, g, qc), dtype=torch.float32, device=dev)
        a0 = torch.zeros((b, hk, g, qc, dh), dtype=torch.float32, device=dev)
        (m, l, acc), _ = scan(kv_step, (m0, l0, a0), (ks, vs, kps))
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = torch.movedim(out, 3, 1).reshape(b, qc, hk * g, dh)
        return None, out.to(COMPUTE_DTYPE)

    # with more than one query chunk, each one's scores are recomputed in
    # the backward instead of kept (the reference's jax.checkpoint)
    step = (functools.partial(layers.checkpoint, q_step) if nq > 1
            else q_step)
    _, outs = scan(step, None, (qs, qps))
    return torch.movedim(outs, 0, 1).reshape(b, sq, h, dh)


def _sdpa_stats(q, k, v, q_pos, k_pos, causal):
    """One device's part of attention over its keys: (max, denominator,
    unnormalised output), float32, as the flash loop carries them."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    q = q.reshape(b, sq, hk, h // hk, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", _f32(q), _f32(k)) \
        * (1.0 / math.sqrt(dh))
    if causal:
        logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, -1e30)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bhgqk,bkhd->bhgqd", _f32(p), _f32(v))
    return m, p.sum(dim=-1), acc


def _sdpa_sharded(q, k, v, q_pos, k_pos, causal):
    """Attention on DTensors under a sharding policy: each device attends
    its own shards (``act.shard_map``).  The batch shards over DP; over
    TP the kv heads when they divide it, else the query heads when each
    device's heads share one kv head, else the query sequence.  A key
    sequence that is sharded (SP-lite decode caches) stays in place: each
    device attends its keys and the softmax merges across the shards by
    an all-reduce of the running max, denominator and output."""
    import torch.distributed._functional_collectives as funcol

    pol = act.policy()
    mesh = pol["mesh"]
    names = list(act.mesh_axes(mesh))
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    dp, tp = act.axis_size("dp") or 1, act.axis_size("tp") or 1
    b_ax = pol["dp"] if (pol["dp"] and b % dp == 0 and b >= dp) else None
    hq_ax = hk_ax = sq_ax = None
    if pol["tp"] and tp > 1:
        if hk % tp == 0:
            hq_ax = hk_ax = pol["tp"]
        elif h % tp == 0 and g % (h // tp) == 0:
            hq_ax = pol["tp"]
        elif sq % tp == 0:
            sq_ax = pol["tp"]
    used = set()
    for ax in (b_ax, hq_ax, sq_ax):
        used.update((ax,) if isinstance(ax, str) else (ax or ()))
    kv_axes = ()
    if hasattr(k, "placements"):
        kv_axes = tuple(names[i] for i, pl in enumerate(k.placements)
                        if pl.is_shard(1) and names[i] not in used)
    n_kv = act.shard_index(mesh, kv_axes)[1] if kv_axes else 1
    if sk % n_kv:
        kv_axes, n_kv = (), 1
    kv_ax = (kv_axes[0] if len(kv_axes) == 1 else kv_axes) or None

    def core(ql, kl, vl, qp, kp):
        if hq_ax and not hk_ax:      # this device's q heads: one kv head
            j = act.shard_index(mesh, hq_ax)[0] * ql.shape[2] // g
            kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
        if sq_ax:
            i, n = act.shard_index(mesh, sq_ax)
            qp = qp.reshape(n, -1)[i]
        if not kv_axes:
            if ql.shape[1] * kl.shape[1] <= QUERY_CHUNK * KV_CHUNK:
                return _sdpa_block(ql, kl, vl, qp, kp, causal)
            return _sdpa_flash(ql, kl, vl, qp, kp, causal)
        i, n = act.shard_index(mesh, kv_axes)
        kp = kp.reshape(n, -1)[i]
        m, den, acc = _sdpa_stats(ql, kl, vl, qp, kp, causal)
        m_all = m
        for ax in kv_axes:
            m_all = funcol.all_reduce(m_all, "max", (mesh, names.index(ax)))
        corr = torch.exp(m - m_all)
        den, acc = den * corr, acc * corr[..., None]
        for ax in kv_axes:
            grp = (mesh, names.index(ax))
            den = funcol.all_reduce(den, "sum", grp)
            acc = funcol.all_reduce(acc, "sum", grp)
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        bl, hkl, gl, sql, _ = out.shape
        return torch.movedim(out, 3, 1).reshape(bl, sql, hkl * gl, dh) \
            .to(COMPUTE_DTYPE)

    q_pl = act.spec_placements(4, b_ax, sq_ax, hq_ax)
    kv_pl = act.spec_placements(4, b_ax, kv_ax, hk_ax)
    out = act.shard_map(core, (q, k, v, q_pos, k_pos),
                        (q_pl, kv_pl, kv_pl, None, None), q_pl)
    return act.constrain(out, "dp", None, "tp", None)


def _sdpa(q, k, v, q_pos, k_pos, causal: bool = True):
    """q (B,Sq,H,Dh), k/v (B,Sk,Hk,Dh) -> (B,Sq,H,Dh); GQA via head
    groups.  Small problems use the unchunked block, larger ones go
    flash; ``QUERY_CHUNK`` and ``KV_CHUNK`` are read at call time.
    Activations are constrained to batch-DP x head-TP under a policy;
    DTensors take :func:`_sdpa_sharded`, which also keeps a sharded key
    sequence in place."""
    if act.sharded(q):
        return _sdpa_sharded(q, k, v, q_pos, k_pos, causal)
    q = act.constrain(q, "dp", None, "tp", None)
    k = act.constrain(k, "dp", None, "tp", None)
    v = act.constrain(v, "dp", None, "tp", None)
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk <= QUERY_CHUNK * KV_CHUNK:
        out = _sdpa_block(q, k, v, q_pos, k_pos, causal)
    else:
        out = _sdpa_flash(q, k, v, q_pos, k_pos, causal)
    return act.constrain(out, "dp", None, "tp", None)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def attention_train(p, x, *, n_heads, n_kv_heads, d_head, rope_theta=10000.0,
                    quant_mode="none", causal=True):
    """Full-sequence self-attention (train / encoder)."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, n_heads, n_kv_heads, d_head, pos[None, :],
                   rope_theta, quant_mode)
    o = _sdpa(q, k, v, pos, pos, causal=causal)
    return apply_linear(act.reshape(o, b, s, n_heads * d_head), p["wo"],
                        quant_mode)


def attention_prefill(p, x, *, n_heads, n_kv_heads, d_head,
                      rope_theta=10000.0, quant_mode="none"):
    """Causal attention that also returns the (k, v) cache to install."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, n_heads, n_kv_heads, d_head, pos[None, :],
                   rope_theta, quant_mode)
    o = _sdpa(q, k, v, pos, pos, causal=True)
    out = apply_linear(act.reshape(o, b, s, n_heads * d_head), p["wo"],
                       quant_mode)
    return out, (k, v)


def _cache_write_sharded(cache, row, new):
    """The decode write of a DTensor cache (B, Smax, Hk, Dh), in place on
    each device's shard as it lies: ``new`` (B, 1, Hk, Dh) goes to the
    cache's layout on the batch and head dims; where the sequence is
    sharded, the shard that holds ``row`` writes it and the others
    rewrite their own row."""
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    names = list(act.mesh_axes(mesh))
    seq_axes = tuple(names[i] for i, pl in enumerate(cache.placements)
                     if pl.is_shard(1))
    new_pl = tuple(Replicate() if pl.is_shard(1) else pl
                   for pl in cache.placements)
    new = new.to(cache.dtype).redistribute(mesh, new_pl).to_local()
    local = cache.to_local()
    row = row.full_tensor() if hasattr(row, "placements") else row
    if not seq_axes:
        local.index_copy_(1, row, new)
        return
    i, _ = act.shard_index(mesh, seq_axes)
    s_loc = local.shape[1]
    lr = row - i * s_loc
    mine = (lr >= 0) & (lr < s_loc)
    lr = torch.clamp(lr, 0, s_loc - 1)
    local.index_copy_(1, lr, torch.where(mine, new,
                                         local.index_select(1, lr)))


def attention_decode(p, x, cache_kv, cache_len, *, n_heads, n_kv_heads,
                     d_head, rope_theta=10000.0, quant_mode="none"):
    """One-token decode: x (B,1,D), cache (k, v) each (B,Smax,Hk_eff,Dh).

    ``cache_len``: a 0-d int tensor on the device, the shared position
    clock.  The new token's k/v row is written IN PLACE into the cache
    tensors (views of the stacked decode state) at row
    ``min(cache_len, Smax - 1)``: the reference's
    ``dynamic_update_slice`` clamps its start index there, while RoPE and
    the mask keep the unclamped clock (ROADMAP C.6, reproduced).  Nothing
    here synchronises with the host.

    Hk_eff may exceed n_kv_heads (KV-head replication): the factor is read
    off the cache shape and the new k/v are repeated to match.
    """
    b = x.shape[0]
    k_cache, v_cache = cache_kv
    s_max = k_cache.shape[1]
    pos = cache_len.expand(b, 1)
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv_heads, d_head, pos,
                           rope_theta, quant_mode)
    hk_eff = k_cache.shape[2]
    if hk_eff != n_kv_heads:
        rep = hk_eff // n_kv_heads
        k_new = torch.repeat_interleave(k_new, rep, dim=2)
        v_new = torch.repeat_interleave(v_new, rep, dim=2)
    row = torch.clamp(cache_len, max=s_max - 1).reshape(1).long()
    if act.sharded(k_cache):
        _cache_write_sharded(k_cache, row, k_new)
        _cache_write_sharded(v_cache, row, v_new)
    else:
        k_cache.index_copy_(1, row, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, row, v_new.to(v_cache.dtype))
    k_pos = torch.arange(s_max, device=x.device)
    # mask: positions <= cache_len are attendable (q_pos = cache_len)
    o = _sdpa(q, k_cache, v_cache, cache_len.reshape(1), k_pos, causal=True)
    out = apply_linear(act.reshape(o, b, 1, n_heads * d_head), p["wo"],
                       quant_mode)
    return out, (k_cache, v_cache)


def cross_attention(p, x, memory, *, n_heads, n_kv_heads, d_head,
                    quant_mode="none"):
    """Decoder -> encoder attention: x (B,Sq,D) against memory (B,Sk,D),
    no RoPE and no mask."""
    b, sq, _ = x.shape
    sk = memory.shape[1]
    q = act.reshape(apply_linear(x, p["wq"], quant_mode), b, sq, n_heads,
                    d_head)
    k = act.reshape(apply_linear(memory, p["wk"], quant_mode), b, sk,
                    n_kv_heads, d_head)
    v = act.reshape(apply_linear(memory, p["wv"], quant_mode), b, sk,
                    n_kv_heads, d_head)
    o = _sdpa(q, k, v, torch.arange(sq, device=x.device),
              torch.arange(sk, device=x.device), causal=False)
    return apply_linear(act.reshape(o, b, sq, n_heads * d_head), p["wo"],
                        quant_mode)
