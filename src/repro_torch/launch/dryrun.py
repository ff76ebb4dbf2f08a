"""Multi-pod dry run: run every (arch x shape x mesh) cell's step on fake
tensors over a fake 256- or 512-rank world.

The port of the reference's ``repro/launch/dryrun.py``.  The reference
lowers and compiles each step for 512 fake XLA devices; here one process
starts a fake process group of 256 or 512 ranks (``launch.mesh``), builds
the step's inputs as DTensors of fake tensors with the shardings of
``sharding.specs`` (never allocating the model) and runs the port's own
step on them, with the activation policy of ``sharding.act`` set, under
``launch.roofline.CostCounter``.  The counter sees one device's local
ops, so each cell records, per device:

  * ``mem``: args, out, temp, alias and peak bytes (the live storages);
  * ``roofline``: FLOPs, HBM bytes and collectives, and their terms on an
    H100 cluster (``launch/roofline.py``);
  * ``model_flops_per_dev``, ``useful_flops_frac``, ``degraded``.

Costs and memory are measured at 1 and 2 superblocks and extrapolated
linearly to the full depth (exact for a stack of identical repeats); a
Python step at full depth would take minutes per cell.  Where a count
falls from 1 to 2 superblocks (DTensor planned the two steps apart),
2 and 3 superblocks are taken instead.  The sLSTM's
per-token loop is replaced by a stand-in of its shapes and its recurrent
FLOPs added analytically, as the reference adds them (``slstm_analytic``
in the cell).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --multi-pod both --out results/dryrun_torch
Without ``--device`` the fake tensors are ``cuda`` tensors (a card must be
present; nothing is allocated on it).  Every cell records the torch
version and the counter's propagation hook; ``--plan`` adds each measured
depth's collectives in issue order, its live bytes when the backward
starts (by the op that made each storage) and its peak, and
``--full-depth`` measures the full depth itself (a check of the
extrapolation).  On ``cpu`` fakes DTensor turns Shard-to-Shard moves into
all-gathers (its CPU fallback for all-to-all), so such cells read higher
than on ``cuda`` fakes.  The exit code is non-zero if any requested cell
fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, arch_names, get_arch
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import api, layers, ssm
from repro_torch.sharding import act
from repro_torch.sharding import specs as sh
from repro_torch.train import loop as tl
from repro_torch.train import optimizer as opt_lib
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_map_with_path_names,
)

log = get_logger("dryrun")

ACT_BUDGET_BYTES = 5e9  # scan-saved activations per device, per microbatch

#: the production meshes (the reference's logical shapes, read as H100s)
#: and the one-card mesh the anchor runs on
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}


def pick_microbatches(cfg, shape, mesh, profile: str = "megatron") -> int:
    """Grad-accum count so the scan-saved residual stream fits HBM."""
    per_dev_seqs = max(shape.global_batch // sh.dp_total(mesh, profile), 1)
    act_per_seq = cfg.n_layers * shape.seq_len * cfg.d_model * 2
    need = max(1, -(-int(per_dev_seqs * act_per_seq) // int(ACT_BUDGET_BYTES)))
    for m in range(need, per_dev_seqs + 1):
        if per_dev_seqs % m == 0:
            return m
    return per_dev_seqs


def pick_optimizer(cfg) -> str:
    """AdamW where its 12 B/param state fits; Adafactor beyond ~50B params."""
    return "adafactor" if api.param_count(cfg) > 50e9 else "adamw"


# ---------------------------------------------------------------------------
# Stand-ins: fake DTensors of the sharded inputs
# ---------------------------------------------------------------------------

def _sharded(meta, sharding: sh.NamedSharding, device):
    """A DTensor of ``meta``'s global shape and dtype whose local shard is
    a fake tensor on ``device`` (call under the counter)."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    pls = sharding.placements
    local = list(meta.shape)
    for md, pl in enumerate(pls):
        if pl.is_shard():
            local[pl.dim] //= mesh.size(md)
    t = torch.empty(local, dtype=meta.dtype, device=device)
    return DTensor.from_local(t, mesh, pls, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _shard_tree(meta_tree, shardings, device):
    return tree_map(lambda m, s: _sharded(m, s, device), meta_tree,
                    shardings)


def _with_micro(batch_m: dict, micro: int) -> dict:
    if micro <= 1:
        return batch_m
    return {k: torch.empty((micro, v.shape[0] // micro, *v.shape[1:]),
                           dtype=v.dtype, device="meta")
            for k, v in batch_m.items()}


@dataclasses.dataclass
class Lowered:
    """A cell's step and its sharded inputs, ready to run under the
    counter (the counterpart of the reference's lowered program)."""

    fn: object
    args: tuple

    def run(self):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        with implicit_replication():
            return self.fn(*self.args)


def _full_depth_shardings(tree, full_tree, mesh, cfg, report):
    """``NamedSharding``s of a reduced-depth parameter (or train-state)
    tree with the specs that ``param_pspec`` gives the full-depth tree's
    leaf of the same name (the FSDP rule reads the stacked leaf's size,
    which grows with depth); an axis that a reduced dim does not divide
    is dropped."""
    full = {}
    tree_map_with_path_names(lambda n, l: full.__setitem__(
        n, sh.param_pspec(n, l, mesh, cfg, report)), full_tree)
    sizes = act.mesh_axes(mesh)

    def fit(name, leaf):
        parts = []
        for dim, ax in zip(leaf.shape, full[name]):
            n = math.prod(sizes[a] for a in ((ax,) if isinstance(ax, str)
                                             else ax)) if ax else 1
            parts.append(ax if ax and dim % n == 0 else None)
        return sh.NamedSharding(mesh, sh.PSpec(*parts))

    return tree_map_with_path_names(fit, tree)


def _train_cell(cfg, shape, mesh, report, profile="megatron",
                remat="block", compression="none", *, device,
                optimizer=None, microbatches=None, full_cfg=None):
    """The full train step (fwd+bwd+optimizer) for this cell."""
    full_cfg = full_cfg or cfg
    micro = microbatches or pick_microbatches(cfg, shape, mesh, profile)
    tcfg = tl.TrainConfig(
        opt=opt_lib.OptConfig(name=optimizer or pick_optimizer(cfg)),
        microbatches=micro, remat=remat, compression=compression,
    )
    step = tl.make_train_step(cfg, tcfg, api.loss_fn(cfg, remat=tcfg.remat))
    state_m = tl.init_train_state(tcfg, api.init_params(cfg, device="meta"))
    full_m = tl.init_train_state(tcfg, api.init_params(full_cfg,
                                                       device="meta"))
    batch_m = _with_micro(cfg.input_specs(shape), micro)
    state_sh = _full_depth_shardings(state_m, full_m, mesh, full_cfg, report)
    batch_sh = sh.batch_shardings(batch_m, mesh, report, micro=micro > 1,
                                  profile=profile)
    return Lowered(step, (_shard_tree(state_m, state_sh, device),
                          _shard_tree(batch_m, batch_sh, device)))


def _prefill_cell(cfg, shape, mesh, report, profile="megatron", *, device,
                  full_cfg=None, **_):
    prefill = api.prefill_fn(cfg)
    params_m = api.init_params(cfg, device="meta")
    batch_m = cfg.input_specs(shape)
    params_sh = _full_depth_shardings(
        params_m, api.init_params(full_cfg or cfg, device="meta"), mesh,
        full_cfg or cfg, report)
    batch_sh = sh.batch_shardings(batch_m, mesh, report, profile=profile)

    def step(params, batch):
        # exported caches dominate prefill memory: pin them to the
        # decode-state layout, as the reference does.  The reference pins
        # the logits by the same rule, which reads their leaf name "0" as
        # a stacked leaf's and moves them from batch to sequence sharding;
        # they stay as the head made them (batch over DP, vocab over TP)
        with torch.no_grad():
            logits, caches = prefill(params, batch)
        # (a reduced-depth run's caches: their degradations not reported)
        pins = sh.decode_state_shardings((logits, caches), mesh, cfg)[1]
        return logits, tree_map(
            lambda x, s: x.redistribute(s.mesh, s.placements), caches, pins)

    return Lowered(step, (_shard_tree(params_m, params_sh, device),
                          _shard_tree(batch_m, batch_sh, device)))


def kv_replication_for(cfg, mesh) -> int:
    """Replicate kv heads up to the TP degree for zero-comm GQA attention
    (bounded by 4x cache growth), as the reference's decode cell does."""
    tp = act.mesh_axes(mesh)["model"]
    return (min(tp // cfg.n_kv_heads, 4)
            if cfg.family != "encdec" and tp > cfg.n_kv_heads else 1)


def _decode_cell(cfg, shape, mesh, report, profile="megatron",
                 kv_replication=0, *, device, full_cfg=None, **_):
    decode = api.decode_fn(cfg)
    b, s = shape.global_batch, shape.seq_len
    if kv_replication == 0:
        kv_replication = kv_replication_for(cfg, mesh)
    params_m = api.init_params(cfg, device="meta")
    state_m = api.init_decode_state(cfg, b, s, kv_replication=kv_replication,
                                    device="meta")
    tok_m = cfg.input_specs(shape)["tokens"]
    params_sh = _full_depth_shardings(
        params_m, api.init_params(full_cfg or cfg, device="meta"), mesh,
        full_cfg or cfg, report)
    state_sh = sh.decode_state_shardings(state_m, mesh, cfg)
    sh.decode_state_shardings(api.init_decode_state(
        full_cfg or cfg, b, s, kv_replication=kv_replication,
        device="meta"), mesh, cfg, report)    # the full depth's report
    tok_sh = sh.batch_shardings(tok_m, mesh, report)
    logits_sh = sh.logits_sharding(mesh, b)

    def step(params, state, tokens):
        with torch.no_grad():
            logits, new = decode(params, state, tokens)
        return logits.redistribute(mesh, logits_sh.placements), new

    return Lowered(step, (_shard_tree(params_m, params_sh, device),
                          _shard_tree(state_m, state_sh, device),
                          _sharded(tok_m, tok_sh, device)))


_LOWER = {"train": _train_cell, "prefill": _prefill_cell,
          "decode": _decode_cell}


def _reduced_cfg(cfg, n_super: int):
    """Same arch with depth = first_k_dense + n_super superblocks."""
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    pat = len(cfg.superblock) if cfg.superblock else 1
    kw = {"n_layers": first_k + n_super * pat}
    if cfg.family == "encdec":
        kw["n_enc_layers"] = n_super
    return dataclasses.replace(cfg, **kw)


def _full_repeats(cfg) -> int:
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    pat = len(cfg.superblock) if cfg.superblock else 1
    return (cfg.n_layers - first_k) // pat


# ---------------------------------------------------------------------------
# The sLSTM stand-in
# ---------------------------------------------------------------------------

def _slstm_standin(p, x, *, n_heads: int = 0):
    """The sLSTM's shapes without its per-token loop: one cell step, its
    hidden state repeated over the sequence, and the output projection.
    The loop's FLOPs are added analytically (:func:`run_cell`)."""
    b, s, d = x.shape
    state = ssm.slstm_init_state(b, d, device=x.device)
    state, h = ssm._slstm_cell(p, x[:, 0], state)
    hs = h[:, None].expand(b, s, d)
    return ssm._mm(hs, p["w_out"]), state


@contextlib.contextmanager
def _slstm_standin_on():
    prev = ssm.slstm_prefill
    ssm.slstm_prefill = _slstm_standin
    try:
        yield
    finally:
        ssm.slstm_prefill = prev


# ---------------------------------------------------------------------------
# Measuring a cell
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            total += t.untyped_storage().nbytes()
    return total


def _storages(tree) -> set:
    return {getattr(t, "_local_tensor", t).untyped_storage()._cdata
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


@contextlib.contextmanager
def _restore(d: dict, saved: dict):
    try:
        yield
    finally:
        d.clear()
        d.update(saved)


def measure(lower, cfg, shape, mesh, device, **overrides) -> dict:
    """Run one cell's step once under a fresh counter: per-device costs,
    collectives and memory (bytes)."""
    counter = rl.CostCounter()
    report = sh.ShardingReport()
    # the RoPE table cache must not keep this counter's fake tensors
    saved_freqs = dict(layers._FREQS)
    layers._FREQS.clear()
    with counter, _restore(layers._FREQS, saved_freqs):
        lowered = lower(cfg, shape, mesh, report, device=device, **overrides)
        with counter.track(lowered.args):
            out = lowered.run()
        end_live = counter.live_bytes
        roof = rl.analyze(counter)
        args_b = counter.args_bytes
        out_b = _local_bytes(out)
        in_st = _storages(lowered.args)
        alias_b = sum(getattr(t, "_local_tensor", t).untyped_storage()
                      .nbytes() for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)
                      and getattr(t, "_local_tensor", t).untyped_storage()
                      ._cdata in in_st)
        peak = counter.peak_bytes
        bwd = counter.live_at_backward
        bwd_by_op = dict(counter.live_by_op_at_backward)
    return {
        "flops": roof.flops, "bytes": roof.hbm_bytes, "coll": roof.coll_bytes,
        "colls": roof.collectives, "args": args_b, "out": out_b,
        "alias": alias_b, "peak": peak, "degraded": report.degraded,
        "backward_live": bwd, "end_live": end_live,
        "ops": list(counter.collective_ops),
        "hook": counter.propagation_hook,
        "backward_live_by_op": bwd_by_op,
    }


def extrapolate(c1: dict, c2: dict, r: int) -> dict:
    """total(R) = c1 + (R-1) * (c2 - c1), per quantity.  The peak is a
    maximum over the step's phases, each linear in depth, and at full
    depth it may sit in another phase than at one or two superblocks: it
    is at least the live bytes at the step's end (old and new state)
    extrapolated, and, with a backward, the 1-superblock run's peak plus
    what each further repeat adds to the live bytes when the backward
    begins (its params, optimizer state and saved activations)."""
    def lin(a, b):
        return a + (r - 1) * (b - a)

    out = {k: max(lin(c1[k], c2[k]), c1[k])
           for k in ("flops", "bytes", "args", "out", "alias", "peak")}
    out["peak"] = max(out["peak"], lin(c1["end_live"], c2["end_live"]))
    if c1.get("backward_live") is not None \
            and c2.get("backward_live") is not None:
        out["peak"] = max(out["peak"], c1["peak"] + (r - 1) * (
            c2["backward_live"] - c1["backward_live"]))
    out["coll"] = max(lin(c1["coll"], c2["coll"]), 0.0)
    colls = {}
    for k in set(c1["colls"]) | set(c2["colls"]):
        n1, b1 = c1["colls"].get(k, (0, 0))
        n2, b2 = c2["colls"].get(k, (0, 0))
        colls[k] = (int(max(lin(n1, n2), 0)), float(max(lin(b1, b2), 0.0)))
    out["colls"] = colls
    return out


def cost_extrapolate(cfg, shape, mesh, device="cuda", full_depth=False,
                     **overrides) -> dict:
    """Per-device costs and memory at full depth from the 1- and
    2-superblock runs, their params sharded as the full config's are.  A
    train cell's microbatch count and optimizer are the full config's
    (the reduced depths would pick fewer microbatches and, past 50B
    params, another optimizer).  ``full_depth`` runs the step once at
    the full depth instead (slow: a check of the extrapolation)."""
    if shape.kind == "train":
        overrides.setdefault("microbatches", pick_microbatches(
            cfg, shape, mesh, overrides.get("profile", "megatron")))
        overrides.setdefault("optimizer", pick_optimizer(cfg))
    def run(n):
        return measure(_LOWER[shape.kind], _reduced_cfg(cfg, n), shape,
                       mesh, device, full_cfg=cfg, **overrides)

    def falls(a, b):
        return [k for k in ("flops", "bytes", "coll") if b[k] < a[k]]

    r = _full_repeats(cfg)
    if full_depth:
        m = measure(_LOWER[shape.kind], cfg, shape, mesh, device,
                    full_cfg=cfg, **overrides)
        out = {k: m[k] for k in ("flops", "bytes", "coll", "colls", "args",
                                 "out", "alias", "peak", "degraded")}
        out.update(falls=[], from_superblocks=(r, r), hook=m["hook"],
                   plan={r: {"peak": m["peak"],
                             "backward_live": m["backward_live"],
                             "backward_live_by_op": m["backward_live_by_op"],
                             "end_live": m["end_live"],
                             "collectives": m["ops"]}})
        return out
    meas, first = [run(1), run(2)], 1
    # a quantity that falls from one superblock to two: DTensor planned
    # the two steps differently; the line through 2 and 3 superblocks
    # is taken instead where the full depth has them
    if falls(*meas) and r >= 3:
        meas, first = [meas[1], run(3)], 2
    out = extrapolate(*meas, r - first + 1)
    out["degraded"] = sorted(set(meas[0]["degraded"])
                             | set(meas[1]["degraded"]))
    out["falls"] = falls(*meas)
    out["from_superblocks"] = (first, first + 1)
    out["hook"] = meas[0]["hook"]
    # each measured depth's collectives in issue order and its memory
    out["plan"] = {first + i: {
        "peak": m["peak"], "backward_live": m["backward_live"],
        "backward_live_by_op": m["backward_live_by_op"],
        "end_live": m["end_live"], "collectives": m["ops"]}
        for i, m in enumerate(meas)}
    return out


def _policy(mesh, profile: str) -> None:
    names = tuple(act.mesh_axes(mesh))
    dp_axes = names if profile == "dp_only" else tuple(
        a for a in names if a != "model")
    act.set_policy(mesh, dp_axes if len(dp_axes) > 1 else dp_axes[0],
                   tp_axis=None if profile == "dp_only" else "model")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             profile: str = "megatron", no_cost: bool = False, *,
             device="cuda", mesh_name: str | None = None,
             shape: ShapeConfig | None = None, cfg=None, plan: bool = False,
             full_depth: bool = False, **overrides) -> dict:
    """One cell: its own fake world, mesh, policy and measurement.
    ``mesh_name`` (a key of :data:`MESHES`), ``shape`` and ``cfg``
    override the production mesh, the named shape and the arch's config
    (the anchor's 1x1 mesh and its 8 x 256 tokens; smoke configs).
    Every cell records the torch version and the counter's propagation
    hook; ``plan`` adds each measured depth's collectives in issue order
    (kind, local operand bytes, result bytes) and its memory;
    ``full_depth`` measures the full depth itself (no extrapolation)."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = mesh_name or ("2x16x16" if multi_pod else "16x16")
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "profile": profile, "torch": torch.__version__,
            **({"overrides": overrides} if overrides else {})}
    if not cfg.supports(shape):
        cell["status"] = "skip"
        cell["reason"] = ("full-attention arch: long_500k needs "
                          "sub-quadratic attention (DESIGN.md)")
        return cell
    dims, axes = MESHES[mesh_name]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run fakes cuda tensors and needs a "
                           "card; pass device='cpu'")
    t0 = time.monotonic()
    try:
        with fake_world(math.prod(dims)), _slstm_standin_on():
            mesh = make_mesh(device.type, dims, axes)
            _policy(mesh, profile)
            try:
                costs = cost_extrapolate(cfg, shape, mesh, device,
                                         full_depth=full_depth,
                                         profile=profile, **overrides)
            finally:
                act.clear_policy()
        n_dev = math.prod(dims)
        # sLSTM layers run a per-token loop that the stand-in skips: add
        # the analytic flop term (w_in + r_in matmuls = 16*D^2/token, x3
        # for the backward)
        n_slstm = (cfg.superblock.count("s") * _full_repeats(cfg)
                   if cfg.superblock else 0)
        toks = shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1)
        if n_slstm:
            mult = 3.0 if shape.kind == "train" else 1.0
            costs["flops"] += n_slstm * toks * 16.0 * cfg.d_model ** 2 \
                * mult / n_dev
            cell["slstm_analytic"] = n_slstm
        cell["from_superblocks"] = costs["from_superblocks"]
        cell["counter_hook"] = costs["hook"]
        if plan:
            cell["plan"] = costs["plan"]
        if costs["falls"]:
            cell["extrapolation_falls"] = costs["falls"]
        if no_cost:
            cell["cost_note"] = "memory proof only (--no-cost)"
            costs.update(flops=0.0, bytes=0.0, coll=0.0, colls={})
        roof = rl.Roofline(flops=costs["flops"], hbm_bytes=costs["bytes"],
                           coll_bytes=costs["coll"],
                           collectives=costs["colls"])
        n_active = api.active_param_count(cfg)
        model_fl = (rl.model_flops_train(n_active, toks)
                    if shape.kind == "train"
                    else rl.model_flops_infer(n_active, toks))
        peak = costs["peak"]
        cell.update(
            status="ok",
            run_s=round(time.monotonic() - t0, 1),
            mem={
                "args_gb": costs["args"] / 1e9,
                "out_gb": costs["out"] / 1e9,
                "temp_gb": (peak - costs["args"]) / 1e9,
                "alias_gb": costs["alias"] / 1e9,
                "peak_gb": peak / 1e9,
            },
            roofline=roof.summary(),
            model_flops_per_dev=model_fl / n_dev,
            useful_flops_frac=(
                (model_fl / n_dev) / roof.flops if roof.flops else None),
            degraded=costs["degraded"],
        )
        log.info("%s/%s/%s ok: %.0fs, peak %.2f GB/dev, dominant=%s",
                 arch, shape_name, mesh_name, cell["run_s"],
                 cell["mem"]["peak_gb"], roof.dominant)
    except Exception as e:  # noqa: BLE001 — report, don't crash the matrix
        cell["status"] = "fail"
        cell["error"] = f"{type(e).__name__}: {e}"[:2000]
        cell["traceback"] = traceback.format_exc()[-2000:]
        log.error("%s/%s/%s FAILED: %s", arch, shape_name, mesh_name,
                  cell["error"][:300])
    return cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-cost", action="store_true",
                    help="memory proof only (the cost terms are zeroed)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (default cuda)")
    ap.add_argument("--plan", action="store_true",
                    help="record each measured depth's collectives in "
                    "issue order and its memory in the cell")
    ap.add_argument("--full-depth", action="store_true",
                    help="measure each cell at its full depth (slow; a "
                    "check of the extrapolation)")
    args = ap.parse_args(argv)

    archs = arch_names() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                name = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = outdir / f"{name}.json"
                if path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        log.info("skip cached %s", name)
                        continue
                cell = run_cell(arch, shape, mp, no_cost=args.no_cost,
                                device=args.device, plan=args.plan,
                                full_depth=args.full_depth)
                path.write_text(json.dumps(cell, indent=2, default=str))
                n_fail += cell["status"] == "fail"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
