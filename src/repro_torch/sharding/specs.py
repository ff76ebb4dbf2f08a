"""Sharding rules: DP / TP (Megatron) / EP / SP-lite over a DeviceMesh.

The port of the reference's ``repro/sharding/specs.py``.  Rules key on
parameter path names (last components) and assign mesh axes to the
*trailing* dims; leading axes (scan repeats, expert stacking handled
explicitly) get None.  Divisibility is checked against the mesh so an
incompatible dim degrades to replication; degradations are collected for
the dry run's report.

The ``*_pspec`` functions return a :class:`PSpec` (a tuple of one entry
per dim: None, an axis name or a tuple of names, element for element the
reference's ``PartitionSpec``); the ``*_shardings`` functions return
:class:`NamedSharding` trees whose ``placements`` are the DTensor
placements on the mesh.

Megatron pairing:
  column-parallel (output feature sharded): wq wk wv, wi_gate wi_up, w_up,
    w_in, lm_head, r_in/w_in (sLSTM), w_dt, conv_w
  row-parallel (input feature sharded, psum after): wo, w_out, w_qkv, w_if,
    w_x, a_log
  expert-parallel: moe wi_gate/wi_up/wo on the expert axis
  vocab-parallel: embed rows
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.sharding.act import mesh_axes, placements
from repro_torch.utils.tree import tree_map, tree_map_with_path_names


class PSpec(tuple):
    """A partition spec: ``PSpec(None, "model")``, one entry per dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor placements."""

    mesh: object
    spec: PSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


# rule: name -> (spec for trailing dims, from the right)
_COL = (None, "model")       # (in, out-sharded)
_ROW = ("model", None)       # (in-sharded, out)
_TRAILING_RULES: dict[str, tuple] = {
    "embed": _ROW,           # vocab rows sharded
    "lm_head": _COL,
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "wi_gate": _COL, "wi_up": _COL,
    "w_up": _COL, "w_in": _COL, "r_in": _COL,
    "w_qkv": _ROW, "w_if": _ROW, "w_x": _ROW, "w_out": _ROW,
    "w_dt": _COL, "conv_w": _COL, "a_log": _ROW,
    "d_skip": ("model",), "skip_gamma": ("model",),
    "router": (None, None),
}
_MOE_NAMES = {"wi_gate", "wi_up", "wo"}

# Per-model-shard size above which a parameter additionally shards over the
# 'data' axis (ZeRO-3/FSDP storage sharding; the step all-gathers it where
# it is used).  Small models stay pure-TP, 33B+ models go TP x FSDP.
FSDP_THRESHOLD_BYTES = 32 * 1024 * 1024


@dataclasses.dataclass
class ShardingReport:
    degraded: list[str] = dataclasses.field(default_factory=list)


def _fits(shape, spec, sizes) -> bool:
    for dim, axis in zip(shape[-len(spec):], spec):
        if axis is None:
            continue
        if dim % sizes[axis] != 0:
            return False
    return True


def _itemsize(leaf) -> int:
    return getattr(getattr(leaf, "dtype", None), "itemsize", 4)


def param_pspec(name: str, leaf, mesh, cfg=None,
                report: ShardingReport | None = None) -> PSpec:
    shape = tuple(leaf.shape)
    sizes = mesh_axes(mesh)
    parts = name.split("/")
    last = parts[-1]
    if last in ("step",):
        return PSpec()

    # expert placement: fine-grained banks that fit per-shard after TP keep
    # experts UNSHARDED (the grouped local-capacity dispatch, no token
    # movement: models/moe.py); big-expert banks go expert-parallel over
    # 'data' + TP inside each expert.  Shared experts are ordinary MLPs.
    if ("moe" in parts and "shared" not in parts and last in _MOE_NAMES
            and len(shape) >= 3):
        e_, a_, b_ = shape[-3], shape[-2], shape[-1]
        bank = 3 * e_ * a_ * b_ * 2 / sizes["model"]
        from repro_torch.models.moe import GROUPED_BANK_BYTES
        if bank <= GROUPED_BANK_BYTES:
            spec = ((None, "model", None) if last == "wo"
                    else (None, None, "model"))
        elif last == "wo":        # (…, E, F, D)
            spec = ("data", "model", None)
        else:                     # wi_gate/wi_up (…, E, D, F)
            spec = ("data", None, "model")
    elif last in _TRAILING_RULES:
        spec = _TRAILING_RULES[last]
    else:
        spec = ()  # norms, scalars, biases -> replicate

    if spec and len(shape) < len(spec):
        spec = spec[-len(shape):]
    if spec and not _fits(shape, spec, sizes):
        if report is not None:
            report.degraded.append(f"{name}{shape} !%{spec}")
        spec = ()
    full = [None] * (len(shape) - len(spec)) + list(spec)

    # FSDP: large per-shard params also shard over 'data' (storage sharding)
    if "data" in sizes and len(shape) >= 2 and "data" not in full:
        shards = math.prod(sizes[ax] for ax in full if ax is not None)
        per_shard = math.prod(shape) // shards * _itemsize(leaf)
        if per_shard > FSDP_THRESHOLD_BYTES:
            dsz = sizes["data"]
            # largest unsharded dim divisible by the data axis, prefer trailing
            cands = [
                i for i in range(len(shape) - 1, -1, -1)
                if full[i] is None and shape[i] % dsz == 0 and shape[i] >= dsz
            ]
            if cands:
                best = max(cands, key=lambda i: shape[i])
                full[best] = "data"
    return PSpec(*full)


def params_shardings(tree, mesh, cfg=None, report=None):
    return tree_map_with_path_names(
        lambda n, l: NamedSharding(mesh, param_pspec(n, l, mesh, cfg,
                                                     report)),
        tree,
    )


# ---------------------------------------------------------------------------
# Batch / cache / state shardings
# ---------------------------------------------------------------------------

def _dp(mesh, profile: str = "megatron"):
    """Data-parallel axes under a sharding profile.

    megatron: DP on non-model axes, TP on 'model'.
    dp_only : DP over EVERY axis (FSDP/ZeRO: models too small to amortize
              TP activation all-reduces).
    """
    names = tuple(mesh_axes(mesh))
    if profile == "dp_only":
        axes = names
    else:
        axes = tuple(a for a in names if a != "model")
    return axes if len(axes) > 1 else axes[0]


def dp_total(mesh, profile: str = "megatron") -> int:
    axes = _dp(mesh, profile)
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def batch_pspec(name: str, leaf, mesh, report=None, micro: bool = False,
                profile: str = "megatron") -> PSpec:
    """tokens/labels (B, S); frontend (B, S, D); micro=True -> (M, B, …)."""
    shape = tuple(leaf.shape)
    dp = _dp(mesh, profile)
    dp_size = dp_total(mesh, profile)
    b_ax = 1 if micro else 0
    if len(shape) <= b_ax or shape[b_ax] % dp_size != 0:
        if profile == "dp_only":  # fall back to the smaller dp group
            return batch_pspec(name, leaf, mesh, report, micro, "megatron")
        if report is not None:
            report.degraded.append(f"batch {name}{shape} replicated")
        return PSpec()
    spec = [None] * len(shape)
    spec[b_ax] = dp
    return PSpec(*spec)


def batch_shardings(batch, mesh, report=None, micro: bool = False,
                    profile: str = "megatron"):
    return tree_map(
        lambda l: NamedSharding(
            mesh, batch_pspec("batch", l, mesh, report, micro, profile)),
        batch,
    )


def decode_state_pspec(name: str, leaf, mesh, cfg=None, report=None) -> PSpec:
    """KV caches (reps, B, S, Hk, Dh) & recurrent states (reps, B, …).

    Batch shards over DP when divisible; otherwise (long_500k B=1) the KV
    *sequence* dim shards over the data axis (SP-lite) and recurrent state
    feature dims shard over model.
    """
    shape = tuple(leaf.shape)
    if not shape:
        return PSpec()  # cache_len scalar
    sizes = mesh_axes(mesh)
    dp = _dp(mesh)
    dp_size = math.prod(v for a, v in sizes.items() if a != "model")
    # batch axis by structure: state['layers']/'self' leaves carry a leading
    # scan-repeats axis; 'head'/'memory' leaves do not.
    top = name.split("/")[0]
    b_ax = 0 if top in ("head", "memory") else min(1, len(shape) - 1)
    msz = sizes["model"]
    if shape[b_ax] % dp_size == 0 and shape[b_ax] >= dp_size:
        spec = [None] * len(shape)
        spec[b_ax] = dp
        # caches also shard a feature dim over 'model' (a 32k x 128-batch
        # KV cache is ~500 GB global: batch sharding alone cannot fit).
        if len(shape) == 5:
            # KV (reps,B,S,Hk,Dh): kv-heads first (zero-comm attention),
            # then the sequence dim (sequence-parallel attention: k/v stay
            # put, softmax reduces tiny cross-shard stats), then Dh.
            order = [3, 2, 4]
        else:
            order = list(range(len(shape) - 1, b_ax, -1))
        for ax in order:
            if ax != b_ax and shape[ax] % msz == 0 and shape[ax] >= msz:
                spec[ax] = "model"
                break
        return PSpec(*spec)
    # batch unshardable (long_500k B=1): SP-lite — shard KV sequence over
    # 'data'; recurrent states shard a feature dim over 'model'.
    s_ax = b_ax + 1
    if len(shape) >= s_ax + 2 and shape[s_ax] % sizes["data"] == 0 \
            and shape[s_ax] >= 4 * sizes["data"]:
        spec = [None] * len(shape)
        spec[s_ax] = "data"
        return PSpec(*spec)
    spec = [None] * len(shape)
    for ax in range(len(shape) - 1, b_ax, -1):
        if shape[ax] % msz == 0 and shape[ax] >= msz:
            spec[ax] = "model"
            break
    else:
        if report is not None:
            report.degraded.append(f"state {name}{shape} replicated")
    return PSpec(*spec)


def decode_state_shardings(state, mesh, cfg=None, report=None):
    return tree_map_with_path_names(
        lambda n, l: NamedSharding(
            mesh, decode_state_pspec(n, l, mesh, cfg, report)),
        state,
    )


def logits_sharding(mesh, global_batch: int | None = None) -> NamedSharding:
    dp = _dp(mesh)
    sizes = mesh_axes(mesh)
    dp_size = math.prod(v for a, v in sizes.items() if a != "model")
    if global_batch is not None and global_batch % dp_size != 0:
        return NamedSharding(mesh, PSpec(None, None, "model"))
    return NamedSharding(mesh, PSpec(dp, None, "model"))


def scalar_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, PSpec())
