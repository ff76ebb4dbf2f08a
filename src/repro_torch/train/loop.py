"""Training loop: gradient accumulation, checkpoints, restart, stragglers.

The step is a function (train state in, train state out), so fault
recovery is exactly "restore + continue".  It runs eagerly: the
reference's ``jit``, buffer donation and ``lax.scan`` over microbatches
become a plain Python step and a Python loop, each microbatch's backward
finishing before the next one's forward.  The process count is 1.

Straggler mitigation: per-host step-time EWMA; hosts slower than
``straggler_factor`` x the median are reported (with one process the
monitor sees one host; the tests drive it with synthetic timings).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.sharding import act
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import schedule as sched_lib
from repro_torch.train.compression import make_transform
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

log = get_logger("train")


@dataclasses.dataclass
class TrainConfig:
    opt: opt_lib.OptConfig = dataclasses.field(
        default_factory=opt_lib.OptConfig)
    microbatches: int = 1
    warmup_steps: int = 100
    total_steps: int = 1000
    remat: str = "block"
    compression: str = "none"
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep_last: int = 3
    straggler_factor: float = 2.0


def value_and_grad(loss_fn: Callable, params, batch):
    """-> (loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params``, as a tree of the same structure
    (the params themselves are not marked); a leaf the loss does not use
    gets zeros, as under ``jax.grad``."""
    leaves, structure = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss = loss_fn(tree_unflatten(structure, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(structure, list(grads))


def make_train_step(cfg_arch, tcfg: TrainConfig, loss_fn: Callable):
    """Returns step(train_state, batch) -> (train_state, metrics).

    train_state = {"params": tree, "opt": optimizer state}; ``loss_fn(
    params, batch)`` returns the scalar loss.  With ``microbatches`` > 1
    every batch leaf has a leading microbatch axis; the losses and
    gradients are averaged over it."""
    del cfg_arch
    transform = make_transform(tcfg.compression)

    def step(state, batch):
        params = state["params"]
        if tcfg.microbatches > 1:
            losses, grads = [], None
            for i in range(tcfg.microbatches):
                mloss, g = value_and_grad(loss_fn, params,
                                          tree_map(lambda x: x[i], batch))
                losses.append(mloss)
                g = tree_map(lambda t: t.to(torch.float32), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
            inv = 1.0 / tcfg.microbatches
            loss = sum(losses) * inv
            grads = tree_map(lambda g: g * inv, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        # under a sharding policy: each gradient reduced to its param's
        # layout once, after the microbatches (DP all-reduce, or
        # reduce-scatter for FSDP storage)
        grads = tree_map(act.like, grads, params)

        lr_scale = sched_lib.warmup_cosine(
            state["opt"]["step"], warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps)
        new_opt, om = opt_lib.update(tcfg.opt, state["opt"], grads, lr_scale,
                                     grad_transform=transform)
        new_params = opt_lib.cast_params_like(new_opt["master"], params)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **om}

    return step


def init_train_state(tcfg: TrainConfig, params) -> dict:
    return {"params": params, "opt": opt_lib.init_opt_state(tcfg.opt,
                                                            params)}


class StragglerMonitor:
    """EWMA per-host step times; flags hosts above factor x median."""

    def __init__(self, n_hosts: int, factor: float = 2.0,
                 alpha: float = 0.2):
        self.ewma = np.zeros(n_hosts)
        self.factor = factor
        self.alpha = alpha
        self.seen = 0

    def record(self, host_times: np.ndarray) -> list[int]:
        if self.seen == 0:
            self.ewma = host_times.astype(float)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * host_times
        self.seen += 1
        med = float(np.median(self.ewma))
        return [i for i, t in enumerate(self.ewma) if t > self.factor * med]


class Trainer:
    """Drives the step: data, checkpoints, restart, monitoring.  A step's
    time (``step_time_s``) runs from the batch in hand to its metrics read
    on the host, which waits for the device."""

    def __init__(self, cfg_arch, tcfg: TrainConfig, loss_fn, params,
                 data_iter):
        self.cfg_arch = cfg_arch
        self.tcfg = tcfg
        self.data_iter = data_iter
        self.state = init_train_state(tcfg, params)
        self.step_idx = 0
        self.step_fn = make_train_step(cfg_arch, tcfg, loss_fn)
        self.monitor = StragglerMonitor(1, tcfg.straggler_factor)
        if tcfg.ckpt_dir:
            self._maybe_restore()

    def _maybe_restore(self):
        last = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            self.step_idx, self.state, _ = ckpt_lib.restore(
                self.tcfg.ckpt_dir, self.state, step=last)
            log.info("resumed at step %d", self.step_idx)

    def run(self, n_steps: int) -> list[dict]:
        history = []
        for _ in range(n_steps):
            batch = next(self.data_iter)
            t0 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.step_idx += 1
            metrics["step"] = self.step_idx
            metrics["step_time_s"] = dt
            self.monitor.record(np.array([dt]))
            history.append(metrics)
            if (self.tcfg.ckpt_dir
                    and self.step_idx % self.tcfg.ckpt_every == 0):
                ckpt_lib.save(
                    self.tcfg.ckpt_dir, self.step_idx, self.state,
                    meta={"arch": getattr(self.cfg_arch, "name", "?")},
                    keep_last=self.tcfg.keep_last)
        return history
