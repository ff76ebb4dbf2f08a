"""The decoder stack of every family but encoder-decoder (PyTorch).

The port of the reference's ``repro/models/stack.py``.  The model is
``first_k_dense`` explicit layers + N repeats of a *superblock* (a fixed
pattern of mixers, e.g. jamba's ``m, a``); the parameter tree is the
reference's: ``blocks[pos]`` holds the superblock position's leaves
stacked ``(reps, ...)``, and the loop over repeats runs on views of them.
Entry points: the full-sequence ``forward`` (modes ``train`` and
``prefill``, the latter also exporting the caches and recurrent states)
and the single-token ``decode_step``.

Mixer codes: ``'a'`` attention, ``'m'`` mamba, ``'M'`` mLSTM, ``'s'``
sLSTM; a layer's FFN is a dense SwiGLU, the MoE (``models.moe``) or none.
The training loss (``lm_loss``) is the next-token cross-entropy of
``chunked_ce_loss`` plus ``AUX_LOSS_COEF`` x the routers' aux loss; in
mode ``train`` each superblock repeat is wrapped by ``RematPolicy(remat)``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.scan_utils import scan
from repro_torch.sharding import act

AUX_LOSS_COEF = 0.01


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

def block_structure(cfg: ArchConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) per superblock position (offset past first_k_dense)."""
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    pattern = cfg.superblock or ("a",)
    return [cfg.layer_kind(first_k + pos) for pos in range(len(pattern))]


def n_repeats(cfg: ArchConfig) -> int:
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    pattern = cfg.superblock or ("a",)
    scanned = cfg.n_layers - first_k
    assert scanned % len(pattern) == 0, (cfg.name, scanned, len(pattern))
    return scanned // len(pattern)


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, generator, mixer: str, ffn: str, *,
                device, lead=()) -> dict:
    """One layer's params; with ``lead=(reps,)`` every leaf is stacked."""
    kw = dict(device=device, lead=lead)
    p: dict = {"norm1": layers.ones((*lead, cfg.d_model), device)}
    if mixer == "a":
        p["attn"] = attn.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, **kw)
    elif mixer == "m":
        p["mamba"] = ssm.init_mamba(generator, cfg.d_model,
                                    d_state=cfg.d_state,
                                    expand=cfg.ssm_expand, **kw)
    elif mixer == "M":
        p["mlstm"] = ssm.init_mlstm(generator, cfg.d_model, cfg.n_heads,
                                    expand=cfg.ssm_expand, **kw)
    elif mixer == "s":
        p["slstm"] = ssm.init_slstm(generator, cfg.d_model, cfg.n_heads,
                                    **kw)
    else:
        raise ValueError(mixer)
    if ffn == "dense":
        p["norm2"] = layers.ones((*lead, cfg.d_model), device)
        p["mlp"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff, **kw)
    elif ffn == "moe":
        m = cfg.moe
        p["norm2"] = layers.ones((*lead, cfg.d_model), device)
        p["moe"] = moe.init_moe(generator, cfg.d_model, m.d_expert,
                                m.n_experts, n_shared=m.n_shared,
                                d_shared=m.d_shared or None, **kw)
    return p


def _apply_mixer(cfg: ArchConfig, p: dict, h, mixer: str, mode: str,
                 cache=None, cache_len=None):
    """Returns (out, new cache or state).  Per mode: train -> None;
    prefill -> exported; decode -> the attention cache updated in place,
    a recurrent layer's new state as new tensors."""
    if mixer == "a":
        kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                  quant_mode=cfg.quant_mode)
        if mode == "train":
            return attn.attention_train(p["attn"], h, **kw), None
        if mode == "prefill":
            return attn.attention_prefill(p["attn"], h, **kw)
        return attn.attention_decode(p["attn"], h, cache, cache_len, **kw)
    if mixer == "m":
        train, prefill, step = (ssm.mamba_train, ssm.mamba_prefill,
                                ssm.mamba_step)
        kw = dict(d_state=cfg.d_state, expand=cfg.ssm_expand)
    elif mixer == "M":
        train, prefill, step = (ssm.mlstm_train, ssm.mlstm_prefill,
                                ssm.mlstm_step)
        kw = dict(n_heads=cfg.n_heads, expand=cfg.ssm_expand)
    elif mixer == "s":
        train, prefill, step = (ssm.slstm_train, ssm.slstm_prefill,
                                ssm.slstm_step)
        kw = {}
    else:
        raise ValueError(mixer)
    p = p[{"m": "mamba", "M": "mlstm", "s": "slstm"}[mixer]]
    if mode == "train":
        return train(p, h, **kw), None
    if mode == "prefill":
        return prefill(p, h, **kw)
    return step(p, h, cache, **kw)


def _norm(h, w):
    """A sublayer's pre-norm; under a sharding policy its output and its
    gradient are batch-DP, so the column-parallel projections' partial
    gradients are summed and reduced once here (Megatron's backward
    all-reduce)."""
    return act.constrain(layers.rmsnorm(h, w), "dp", None, None)


def _residual(h, out):
    """``h + out``; under a sharding policy the sublayer's row-parallel
    output, a partial sum over TP, is reduced before the add (Megatron's
    all-reduce), so that no DTensor planner defers it past the add."""
    return h + act.constrain(out, "dp", None, None)


def apply_layer(cfg: ArchConfig, p: dict, h, mixer: str, ffn: str, mode: str,
                cache=None, cache_len=None):
    """Pre-norm residual layer.  Returns (h, new_cache, aux_loss); the aux
    loss is the MoE router's (a float32 0-d tensor), else 0.0."""
    h = act.constrain(h, "dp", None, None)
    mixed, new_cache = _apply_mixer(
        cfg, p, _norm(h, p["norm1"]), mixer, mode, cache, cache_len)
    h = _residual(h, mixed)
    aux = 0.0
    if ffn == "dense":
        h = _residual(h, layers.apply_mlp(p["mlp"], _norm(h, p["norm2"]),
                                          cfg.quant_mode))
    elif ffn == "moe":
        out, aux = moe.apply_moe(p["moe"], _norm(h, p["norm2"]),
                                 top_k=cfg.moe.top_k,
                                 quant_mode=cfg.quant_mode)
        h = _residual(h, out)
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (the draws
    cannot equal ``jax.random``'s); on the ``meta`` device only shapes."""
    struct = block_structure(cfg)
    reps = n_repeats(cfg)
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    params: dict = {
        "embed": layers.embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                   device=device),
        "out_norm": layers.ones((cfg.d_model,), device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            generator, cfg.d_model, cfg.padded_vocab, device=device)
    params["head_layers"] = [
        _init_layer(cfg, generator, "a", "dense", device=device)
        for _ in range(first_k)
    ]
    params["blocks"] = [
        _init_layer(cfg, generator, mixer, ffn, device=device, lead=(reps,))
        for mixer, ffn in struct
    ]
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed_sharded(table, tokens):
    """The lookup on DTensors under a policy: each device looks up the
    tokens in its rows of the (vocab-sharded) table, zero elsewhere; the
    result is a partial sum over the axes that shard the vocabulary."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = table.device_mesh
    names = list(act.mesh_axes(mesh))
    v_axes = tuple(names[i] for i, pl in enumerate(table.placements)
                   if pl.is_shard(0))
    t_pl = tuple(pl if pl.is_shard(0) else Replicate()
                 for pl in table.placements)
    tok_pl = tuple(pl if pl.is_shard(0) and names[i] not in v_axes
                   else Replicate() for i, pl in enumerate(tokens.placements))
    out_pl = tuple(Partial() if names[i] in v_axes else pl
                   for i, pl in enumerate(tok_pl))

    def local(tab, tok):
        if not v_axes:
            return tab[tok]
        i, _ = act.shard_index(mesh, v_axes)
        rel = tok.long() - i * tab.shape[0]
        mine = (rel >= 0) & (rel < tab.shape[0])
        rows = tab[torch.clamp(rel, 0, tab.shape[0] - 1)]
        return rows * mine[..., None].to(rows.dtype)

    return act.shard_map(local, (table, tokens), (t_pl, tok_pl), out_pl)


def embed_lookup(params, tokens):
    """The token embeddings in bf16; vocab-parallel on DTensors under a
    sharding policy (:func:`_embed_sharded`)."""
    if act.sharded(params["embed"]):
        h = _embed_sharded(act.gather_dp(params["embed"]), tokens)
    else:
        h = params["embed"][tokens]
    return h.to(COMPUTE_DTYPE)


def _embed_inputs(cfg: ArchConfig, params, tokens, frontend=None):
    """Token ids are never clamped: an id outside the table raises (the
    reference's gather clamps it instead).  On DTensors under a sharding
    policy the table stays vocab-parallel (:func:`_embed_sharded`)."""
    h = embed_lookup(params, tokens)
    if frontend is not None:
        h = torch.cat([act.constrain(frontend.to(COMPUTE_DTYPE), "dp"),
                       act.constrain(h, "dp")], dim=1)
    return act.constrain(h, "dp", None, None)


def _head_f32(w: torch.Tensor) -> torch.Tensor:
    """The output projection upcast to float32, made once per weight
    tensor and kept on it (re-made if the tensor is written in place).
    A weight that takes a gradient gets a fresh copy in every call: a
    kept copy would carry one graph into the next."""
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(torch.float32)
    cached = getattr(w, "_f32_copy", None)
    if cached is None or cached[0] != w._version:
        cached = (w._version, w.to(torch.float32))
        w._f32_copy = cached
    return cached[1]


def _head(cfg: ArchConfig, params) -> torch.Tensor:
    """The (D, V) output projection in float32."""
    if cfg.tie_embeddings:
        return _head_f32(act.gather_dp(params["embed"])).T
    return _head_f32(act.gather_dp(params["lm_head"]))


def _project(h, norm, w32):
    """float32 logits: the reference's bf16 product with a float32 result,
    as a float32 product of the upcast operands (exact products)."""
    return act.matmul(_norm(h, norm).to(torch.float32), w32,
                      torch.matmul)


def _logits(cfg: ArchConfig, params, h):
    h = act.constrain(h, "dp", None, None)
    return _project(h, params["out_norm"], _head(cfg, params))


def forward_hidden(cfg: ArchConfig, params, tokens, frontend=None,
                   mode: str = "train", remat: str = "block"):
    """Embed + all blocks, WITHOUT the output projection.

    -> (h, caches, aux): caches only when mode='prefill', stacked
    ``(reps, ...)`` per superblock position; aux the sum of the MoE
    routers' losses (float32, 0-d).  In mode ``train`` each superblock
    repeat runs under ``layers.RematPolicy(remat)``."""
    struct = block_structure(cfg)
    h = _embed_inputs(cfg, params, tokens, frontend)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in params["head_layers"]:
        h, _, aux = apply_layer(cfg, p, h, "a", "dense", "train")
        aux_total = aux_total + aux

    def superblock(h, rep_params):
        caches = []
        aux_sb = torch.zeros((), dtype=torch.float32, device=h.device)
        for pos, (mixer, ffn) in enumerate(struct):
            h, cache, aux = apply_layer(cfg, rep_params[pos], h, mixer, ffn,
                                        mode)
            aux_sb = aux_sb + aux
            caches.append(cache)
        return h, ((tuple(caches) if mode == "prefill" else None), aux_sb)

    policy = layers.RematPolicy(remat)
    sb = policy.wrap(superblock) if mode == "train" else superblock
    h, (caches, auxes) = scan(sb, h, tuple(params["blocks"]))
    return h, caches, aux_total + torch.sum(auxes)


def forward(cfg: ArchConfig, params, tokens, frontend=None,
            mode: str = "train", remat: str = "block"):
    """Full-sequence forward -> (float32 logits, aux) in mode 'train',
    (logits, caches) in mode 'prefill'."""
    with layers.lm_precision():
        h, caches, aux = forward_hidden(cfg, params, tokens, frontend, mode,
                                        remat)
        logits = _logits(cfg, params, h)
    if mode == "prefill":
        return logits, caches
    return logits, aux


# ---------------------------------------------------------------------------
# Decode (single token, caches and states updated in place)
# ---------------------------------------------------------------------------

def _mixer_state(cfg: ArchConfig, mixer: str, batch: int, max_seq: int,
                 hk_eff: int, device, lead=()) -> tuple:
    """One layer's zeroed decode state, the reference's shapes: (k, v)
    (B, max_seq, Hk_eff, Dh) bf16 for attention; float32 recurrent states
    independent of ``max_seq``: mamba (B, Di, N), (B, 3, Di); mLSTM
    (B, H, dk, dk), (B, H, dk), (B, H); sLSTM four (B, D)."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((*lead, batch, *shape), dtype=dtype,
                           device=device)

    d_inner = cfg.ssm_expand * cfg.d_model
    if mixer == "a":
        return tuple(zeros(max_seq, hk_eff, cfg.head_dim,
                           dtype=torch.bfloat16) for _ in range(2))
    if mixer == "m":
        return zeros(d_inner, cfg.d_state), zeros(3, d_inner)  # d_conv-1
    if mixer == "M":
        dk = d_inner // cfg.n_heads
        return (zeros(cfg.n_heads, dk, dk), zeros(cfg.n_heads, dk),
                zeros(cfg.n_heads))
    if mixer == "s":
        return tuple(zeros(cfg.d_model) for _ in range(4))
    raise ValueError(mixer)


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      kv_replication: int = 1, *, device) -> dict:
    """Zeroed caches and states, stacked (reps, ...) per superblock
    position, and the shared position clock ``cache_len`` (0-d int32 on
    the device).

    kv_replication=r stores each kv head r times (see
    ``attention.attention_decode``)."""
    reps = n_repeats(cfg)
    hk_eff = cfg.n_kv_heads * kv_replication
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    return {
        "cache_len": torch.zeros((), dtype=torch.int32, device=device),
        "layers": [_mixer_state(cfg, mixer, batch, max_seq, hk_eff, device,
                                (reps,))
                   for mixer, _ in block_structure(cfg)],
        # head (unscanned) layers are always attention
        "head": [_mixer_state(cfg, "a", batch, max_seq, hk_eff, device)
                 for _ in range(first_k)],
    }


def index_tree(tree, r: int):
    """Repeat ``r``'s views of a stacked layer tree."""
    if isinstance(tree, dict):
        return {k: index_tree(v, r) for k, v in tree.items()}
    return tree[r]


def decode_step(cfg: ArchConfig, params, state: dict, tokens):
    """tokens (B,1) -> (float32 logits (B,1,V), new state).

    Consumes ``state``: each attention layer's new k/v row is written in
    place into the stacked caches, and each recurrent layer's new state
    is copied in place into its stacked rows; the new state shares those
    tensors (as the reference's donated decode state is reused), and
    ``cache_len`` is a new 0-d tensor, one past the old.  No host
    synchronisation happens here."""
    struct = block_structure(cfg)
    cache_len = state["cache_len"]
    with layers.lm_precision():
        h = _embed_inputs(cfg, params, tokens)
        for p, cache in zip(params["head_layers"], state["head"]):
            h, _, _ = apply_layer(cfg, p, h, "a", "dense", "decode",
                                  cache=cache, cache_len=cache_len)
        for r in range(n_repeats(cfg)):
            for pos, (mixer, ffn) in enumerate(struct):
                cache = tuple(leaf[r] for leaf in state["layers"][pos])
                h, new, _ = apply_layer(
                    cfg, index_tree(params["blocks"][pos], r), h, mixer, ffn,
                    "decode", cache=cache, cache_len=cache_len)
                if mixer != "a":
                    for old, nw in zip(cache, new):
                        old.copy_(nw)
        logits = _logits(cfg, params, h)
    new_state = {
        "cache_len": cache_len + 1,
        "layers": state["layers"],
        "head": state["head"],
    }
    return logits, new_state


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

class _VocabParallelNLL(torch.autograd.Function):
    """-log_softmax(logits)[y] of one device's vocabulary slice (float32
    logits (..., V_loc) holding columns [lo, lo + V_loc)): the max, the
    sum of exponentials and the target logit are all-reduced over
    ``groups`` (the mesh dims that shard the vocabulary), so no device
    holds the whole row; the backward is local (softmax - one-hot)."""

    @staticmethod
    def forward(ctx, logits, y, lo, groups):
        import torch.distributed._functional_collectives as funcol

        v_loc = logits.shape[-1]
        m = logits.amax(dim=-1)
        for grp in groups:
            m = funcol.all_reduce(m, "max", grp)
        e = torch.exp(logits - m[..., None])
        den = e.sum(dim=-1)
        local = y - lo
        mine = (local >= 0) & (local < v_loc)
        idx = torch.clamp(local, 0, v_loc - 1)[..., None]
        tgt = torch.gather(logits, -1, idx)[..., 0] * mine
        for grp in groups:
            den = funcol.all_reduce(den, "sum", grp)
            tgt = funcol.all_reduce(tgt, "sum", grp)
        ctx.save_for_backward(e, den, idx, mine)
        return torch.log(den) + m - tgt

    @staticmethod
    def backward(ctx, g):
        e, den, idx, mine = ctx.saved_tensors
        grad = e / den[..., None]
        grad = grad.scatter_add(-1, idx, -mine.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _nll_sharded(logits, y):
    """The chunk's NLL on DTensors under a sharding policy: each device
    takes its vocabulary slice (``_VocabParallelNLL``), the batch over DP
    as it lies."""
    from torch.distributed.tensor import Replicate

    mesh = logits.device_mesh
    lg_pl = tuple(pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
                  for pl in logits.placements)
    v_dims = [i for i, pl in enumerate(lg_pl) if pl.is_shard(2)]
    groups = [(mesh, i) for i in v_dims]
    y_pl = tuple(Replicate() if i in v_dims else pl
                 for i, pl in enumerate(lg_pl))

    def local(lg, yl):
        lo = 0
        if v_dims:
            names = list(act.mesh_axes(mesh))
            i, _ = act.shard_index(mesh, tuple(names[d] for d in v_dims))
            lo = i * lg.shape[-1]
        return _VocabParallelNLL.apply(lg, yl, lo, groups)

    return act.shard_map(local, (logits, y), (lg_pl, y_pl), y_pl)


def chunked_ce_loss(project_fn, h, labels, vocab: int, padded_vocab: int,
                    chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materialising the full (B,S,V) float32
    logits: the projection and log-softmax run per sequence chunk under
    ``layers.checkpoint``, so the forward keeps no chunk's logits and the
    backward recomputes each.  A sequence that ``chunk`` does not divide
    runs as one chunk.  Labels outside [0, vocab) are masked; the gather
    index is clipped to [0, padded_vocab - 1]; the softmax runs over all
    ``padded_vocab`` columns, as the reference's does.  -> the mean over
    the unmasked labels (float32, 0-d; 0 when every label is masked)."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # irregular tail: fall back to one chunk
    n = s // chunk
    hc = torch.movedim(act.reshape(h, b, n, chunk, d), 1, 0)
    yc = torch.movedim(labels.reshape(b, n, chunk), 1, 0).long()

    def one_chunk(carry, xs):
        h_c, y_c = xs
        logits = project_fn(h_c)                            # (B,chunk,V)
        y_idx = torch.clamp(y_c, 0, padded_vocab - 1)
        if act.sharded(logits):
            nll = _nll_sharded(logits, y_idx)
        else:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, y_idx[..., None])[..., 0]
        mask = ((y_c >= 0) & (y_c < vocab)).to(torch.float32)
        return (carry[0] + torch.sum(nll * mask),
                carry[1] + torch.sum(mask)), None

    zero = act.sum_zero(h)
    (tot, cnt), _ = scan(functools.partial(layers.checkpoint, one_chunk),
                         (zero, zero), (hc, yc))
    return tot / torch.clamp(cnt, min=1)


def lm_loss(cfg: ArchConfig, params, tokens, labels, frontend=None,
            remat: str = "block", loss_chunk: int = 512):
    """Next-token cross-entropy (labels aligned with the token positions;
    with a frontend, over the text positions only) plus ``AUX_LOSS_COEF``
    x the routers' aux loss.  The forward and the backward run under
    ``layers.lm_precision``; the head is upcast once per call."""
    with layers.lm_precision():
        h, _, aux = forward_hidden(cfg, params, tokens, frontend,
                                   mode="train", remat=remat)
        if frontend is not None:
            h = h[:, -tokens.shape[1]:]
        h = act.constrain(h, "dp", None, None)
        w32 = _head(cfg, params)
        loss = chunked_ce_loss(
            functools.partial(_project, norm=params["out_norm"], w32=w32),
            h, labels, cfg.vocab, cfg.padded_vocab, chunk=loss_chunk)
        loss = loss + AUX_LOSS_COEF * aux
    return layers.backward_at_lm_precision(loss)
