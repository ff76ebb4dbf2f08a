"""Functional optimizers over parameter trees: AdamW, SGD (+momentum),
Lion and Adafactor.

The reference's optimizers (``repro/train/optimizer.py``), as plain
functions over a tree of tensors rather than ``torch.optim`` classes,
because their arithmetic differs from PyTorch's: the update is ``p - lr
* (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the bias corrections
taken after the step counter moves; weight decay applies to every leaf
(the affines ``a``, ``b`` and ``temp`` included); and the gradients are
clipped by their global norm before the moments.

The optimizer keeps a float32 master copy of the params and its moments;
``update`` returns the new state, and ``cast_params_like`` casts the
master back to the model's dtypes.  Every entry point works on the
device the tree lies on and returns new tensors (no update in place).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils.tree import (
    global_norm,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    clip_norm: float = 1.0


def init_opt_state(cfg: OptConfig, params) -> dict:
    """``step`` (int32, 0), a float32 ``master`` copy (never aliasing the
    params) and the optimizer's moments, zero."""
    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    state = {"step": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
             "master": tree_map(lambda x: x.detach().to(torch.float32,
                                                        copy=True), params)}
    if cfg.name == "adamw":
        state["m"] = tree_map(zeros, params)
        state["v"] = tree_map(zeros, params)
    elif cfg.name in ("sgd", "lion"):
        state["m"] = tree_map(zeros, params)
    elif cfg.name == "adafactor":
        # factored second moment: a row and a column statistic per matrix
        def vrow(x):
            return torch.zeros(x.shape[:-1] if x.ndim >= 2 else x.shape,
                               dtype=torch.float32, device=x.device)

        def vcol(x):
            return torch.zeros(x.shape[:-2] + x.shape[-1:] if x.ndim >= 2
                               else (1,), dtype=torch.float32,
                               device=x.device)

        state["v_row"] = tree_map(vrow, params)
        state["v_col"] = tree_map(vcol, params)
    else:
        raise ValueError(cfg.name)
    return state


def _clip(grads, clip_norm: float):
    """Scale ``grads`` so their global norm is at most ``clip_norm``
    (``+1e-9`` in the divisor); -> (grads, the norm before clipping, 0
    when clipping is off)."""
    if clip_norm <= 0:
        return grads, torch.zeros((), dtype=torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


@torch.no_grad()
def update(cfg: OptConfig, state: dict, grads, lr_scale=1.0,
           grad_transform: Callable | None = None):
    """-> (new optimizer state, {"grad_norm", "lr"})."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if grad_transform is not None:
        grads, state = grad_transform(grads, state)
    grads, gnorm = _clip(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)
    master = state["master"]

    if cfg.name == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state["v"], grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)

        def upd(p, m_, v_):
            mh = m_ / bc1
            vh = v_ / bc2
            return p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                             + cfg.weight_decay * p)

        master = tree_map(upd, master, m, v)
        new_state = {"step": step, "master": master, "m": m, "v": v}
    elif cfg.name == "sgd":
        m = tree_map(lambda m_, g: cfg.momentum * m_ + g, state["m"], grads)
        master = tree_map(lambda p, m_: p - lr * m_, master, m)
        new_state = {"step": step, "master": master, "m": m}
    elif cfg.name == "lion":
        b1, b2 = cfg.beta1, cfg.beta2

        def upd(p, m_, g):
            u = torch.sign(b1 * m_ + (1 - b1) * g)
            return p - lr * (u + cfg.weight_decay * p)

        master = tree_map(upd, master, state["m"], grads)
        m = tree_map(lambda m_, g: b2 * m_ + (1 - b2) * g, state["m"], grads)
        new_state = {"step": step, "master": master, "m": m}
    elif cfg.name == "adafactor":
        b2 = cfg.beta2

        def upd_factored(p, g, vr, vc):
            if g.ndim >= 2:
                vr_n = b2 * vr + (1 - b2) * torch.mean(torch.square(g), -1)
                vc_n = b2 * vc + (1 - b2) * torch.mean(torch.square(g), -2)
                r = vr_n / torch.clamp(vr_n.mean(-1, keepdim=True),
                                       min=1e-30)
                v_hat = r[..., None] * vc_n[..., None, :]
            else:
                vr_n = b2 * vr + (1 - b2) * torch.square(g)
                vc_n = vc
                v_hat = vr_n
            u = g * torch.rsqrt(v_hat + cfg.eps)
            # update clipping (Adafactor's RMS-1 rule)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            return (p - lr * (u + cfg.weight_decay * p), vr_n,
                    vc_n)

        leaves, structure = tree_flatten(grads)
        outs = [upd_factored(*a) for a in zip(
            tree_leaves(master), leaves, tree_leaves(state["v_row"]),
            tree_leaves(state["v_col"]))]
        master, v_row, v_col = (tree_unflatten(structure,
                                               [o[i] for o in outs])
                                for i in range(3))
        new_state = {"step": step, "master": master, "v_row": v_row,
                     "v_col": v_col}
    else:
        raise ValueError(cfg.name)

    return new_state, {"grad_norm": gnorm, "lr": lr}


def cast_params_like(master, params_template):
    """float32 master -> the model's dtype per leaf, for the forward."""
    return tree_map(lambda m, p: m.to(p.dtype), master, params_template)
