"""The decoder stack of the dense and VLM families (PyTorch).

The port of the reference's ``repro/models/stack.py``.  The model is
``first_k_dense`` explicit layers + N repeats of a *superblock*; the
parameter tree is the reference's: ``blocks[pos]`` holds the superblock
position's leaves stacked ``(reps, ...)``, and the loop over repeats runs
on views of them.  Entry points: the full-sequence ``forward`` (modes
``train`` and ``prefill``, the latter also exporting the KV caches) and
the single-token ``decode_step``.

Served here: attention mixers (``'a'``) with dense SwiGLU FFNs, which is
all the ``dense`` and ``vlm`` families use.  The mamba (``'m'``), mLSTM
(``'M'``) and sLSTM (``'s'``) mixers and the MoE FFN raise
``NotImplementedError`` naming ROADMAP A.13b; the loss (``lm_loss``,
``chunked_ce_loss``) waits for A.13c.

:func:`params_from_numpy` and :func:`params_to_numpy` carry weights
between the reference's tree (through numpy) and the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.layers import COMPUTE_DTYPE, PARAM_DTYPE
from repro_torch.models.scan_utils import scan
from repro_torch.utils.tree import tree_map

#: what the families that are not served yet wait for
LATER = ("ROADMAP A.13b: the MoE, SSM/xLSTM, hybrid and encoder-decoder "
         "families are not ported yet")


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {LATER}")


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


def _check_served(cfg: ArchConfig) -> None:
    for mixer, ffn in block_structure(cfg):
        if mixer != "a":
            raise _later(f"{cfg.name}: mixer {mixer!r}")
        if ffn == "moe":
            raise _later(f"{cfg.name}: the MoE FFN")


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, generator, mixer: str, ffn: str, *,
                device, lead=()) -> dict:
    """One layer's params; with ``lead=(reps,)`` every leaf is stacked."""
    if mixer != "a":
        raise _later(f"{cfg.name}: mixer {mixer!r}")
    p: dict = {"norm1": layers.ones((*lead, cfg.d_model), device)}
    p["attn"] = attn.init_attention(
        generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        qk_norm=cfg.qk_norm, device=device, lead=lead)
    if ffn == "dense":
        p["norm2"] = layers.ones((*lead, cfg.d_model), device)
        p["mlp"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                   device=device, lead=lead)
    elif ffn == "moe":
        raise _later(f"{cfg.name}: the MoE FFN")
    return p


def _apply_mixer(cfg: ArchConfig, p: dict, h, mixer: str, mode: str,
                 cache=None, cache_len=None):
    """Returns (out, new_cache).  Cache semantics per mode: train -> None;
    prefill -> exported; decode -> updated in place."""
    if mixer != "a":
        raise _later(f"{cfg.name}: mixer {mixer!r}")
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
              quant_mode=cfg.quant_mode)
    if mode == "train":
        return attn.attention_train(p["attn"], h, **kw), None
    if mode == "prefill":
        return attn.attention_prefill(p["attn"], h, **kw)
    return attn.attention_decode(p["attn"], h, cache, cache_len, **kw)


def apply_layer(cfg: ArchConfig, p: dict, h, mixer: str, ffn: str, mode: str,
                cache=None, cache_len=None):
    """Pre-norm residual layer.  Returns (h, new_cache, aux_loss); the aux
    loss is the MoE router's, so 0.0 for every family served here."""
    mixed, new_cache = _apply_mixer(
        cfg, p, layers.rmsnorm(h, p["norm1"]), mixer, mode, cache, cache_len)
    h = h + mixed
    if ffn == "dense":
        h = h + layers.apply_mlp(p["mlp"], layers.rmsnorm(h, p["norm2"]),
                                 cfg.quant_mode)
    elif ffn == "moe":
        raise _later(f"{cfg.name}: the MoE FFN")
    return h, new_cache, 0.0


# ---------------------------------------------------------------------------
# Whole-model init, and weights across the numpy bridge
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (the draws
    cannot equal ``jax.random``'s); on the ``meta`` device only shapes."""
    _check_served(cfg)
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


def _keyed_map(fn, tree, key=""):
    if isinstance(tree, dict):
        return {k: _keyed_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_keyed_map(fn, v, key) for v in tree)
    return fn(key, tree)


def params_from_numpy(tree, device=None) -> dict:
    """The reference's parameter tree (numpy arrays, or JAX arrays through
    ``np.asarray``) as the port's on ``device`` (default: the card, by
    ``ops.resolve_device``).  Float32 arrays are accepted for every leaf
    (bf16 -> float32 -> bf16 is lossless); ``ml_dtypes`` bf16 arrays are
    read as their raw 16-bit words, so ``ml_dtypes`` need not be
    installed.  Norm gains stay float32, every other leaf becomes
    ``PARAM_DTYPE``."""
    device = ops.resolve_device(None, device)

    def leaf(key, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        # norm1, norm2, out_norm, q_norm, k_norm: the float32 gains
        dtype = torch.float32 if "norm" in key else PARAM_DTYPE
        return t.to(device=device, dtype=dtype)

    return _keyed_map(leaf, tree)


def params_to_numpy(params) -> dict:
    """The port's parameter tree as float32 numpy arrays on the host
    (numpy has no bf16; the values are the bf16 ones, exactly)."""
    return tree_map(lambda t: t.detach().to(torch.float32).cpu().numpy(),
                    params)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params, tokens, frontend=None):
    """Token ids are never clamped: an id outside the table raises (the
    reference's gather clamps it instead)."""
    h = params["embed"][tokens].to(COMPUTE_DTYPE)
    if frontend is not None:
        h = torch.cat([frontend.to(COMPUTE_DTYPE), h], dim=1)
    return h


def _head_f32(w: torch.Tensor) -> torch.Tensor:
    """The output projection upcast to float32, made once per weight
    tensor and kept on it (re-made if the tensor is written in place)."""
    cached = getattr(w, "_f32_copy", None)
    if cached is None or cached[0] != w._version:
        cached = (w._version, w.to(torch.float32))
        w._f32_copy = cached
    return cached[1]


def _logits(cfg: ArchConfig, params, h):
    """float32 logits: the reference's bf16 product with a float32 result,
    as a float32 product of the upcast operands (exact products)."""
    h = layers.rmsnorm(h, params["out_norm"])
    if cfg.tie_embeddings:
        w = _head_f32(params["embed"]).T
    else:
        w = _head_f32(params["lm_head"])
    return torch.matmul(h.to(torch.float32), w)


def forward_hidden(cfg: ArchConfig, params, tokens, frontend=None,
                   mode: str = "train"):
    """Embed + all blocks, WITHOUT the output projection.

    -> (h, caches, aux): caches only when mode='prefill', stacked
    ``(reps, ...)`` per superblock position."""
    _check_served(cfg)
    struct = block_structure(cfg)
    h = _embed_inputs(cfg, params, tokens, frontend)
    for p in params["head_layers"]:
        h, _, _ = apply_layer(cfg, p, h, "a", "dense", "train")

    def superblock(h, rep_params):
        caches = []
        for pos, (mixer, ffn) in enumerate(struct):
            h, cache, _ = apply_layer(cfg, rep_params[pos], h, mixer, ffn,
                                      mode)
            caches.append(cache)
        return h, (tuple(caches) if mode == "prefill" else None)

    h, caches = scan(superblock, h, tuple(params["blocks"]))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, caches, aux


def forward(cfg: ArchConfig, params, tokens, frontend=None,
            mode: str = "train"):
    """Full-sequence forward -> (float32 logits, aux) in mode 'train',
    (logits, caches) in mode 'prefill'."""
    with layers.lm_precision():
        h, caches, aux = forward_hidden(cfg, params, tokens, frontend, mode)
        logits = _logits(cfg, params, h)
    if mode == "prefill":
        return logits, caches
    return logits, aux


# ---------------------------------------------------------------------------
# Decode (single token, cache update in place)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      kv_replication: int = 1, *, device) -> dict:
    """Zeroed caches, stacked (reps, ...) per superblock position, and the
    shared position clock ``cache_len`` (0-d int32 on the device).

    kv_replication=r stores each kv head r times (see
    ``attention.attention_decode``)."""
    _check_served(cfg)
    reps = n_repeats(cfg)
    hk_eff = cfg.n_kv_heads * kv_replication

    def kv(*lead):
        shape = (*lead, batch, max_seq, hk_eff, cfg.head_dim)
        return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
                torch.zeros(shape, dtype=torch.bfloat16, device=device))

    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    return {
        "cache_len": torch.zeros((), dtype=torch.int32, device=device),
        "layers": [kv(reps) for _ in block_structure(cfg)],
        # head (unscanned) layers are always attention
        "head": [kv() for _ in range(first_k)],
    }


def _index(tree, r: int):
    """Repeat ``r``'s views of a stacked layer tree."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def decode_step(cfg: ArchConfig, params, state: dict, tokens):
    """tokens (B,1) -> (float32 logits (B,1,V), new state).

    Consumes ``state``: each layer's new k/v row is written in place into
    the stacked caches, which the new state shares (as the reference's
    donated decode state is reused); ``cache_len`` is a new 0-d tensor,
    one past the old.  No host synchronisation happens here."""
    struct = block_structure(cfg)
    cache_len = state["cache_len"]
    with layers.lm_precision():
        h = _embed_inputs(cfg, params, tokens)
        for p, cache in zip(params["head_layers"], state["head"]):
            h, _, _ = apply_layer(cfg, p, h, "a", "dense", "decode",
                                  cache=cache, cache_len=cache_len)
        for r in range(n_repeats(cfg)):
            for pos, (mixer, ffn) in enumerate(struct):
                k, v = state["layers"][pos]
                h, _, _ = apply_layer(
                    cfg, _index(params["blocks"][pos], r), h, mixer, ffn,
                    "decode", cache=(k[r], v[r]), cache_len=cache_len)
        logits = _logits(cfg, params, h)
    new_state = {
        "cache_len": cache_len + 1,
        "layers": state["layers"],
        "head": state["head"],
    }
    return logits, new_state
