"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      --device cpu

The port of the reference's ``repro/launch/train.py``, on one device
(``--device``, default ``cuda``: the card; with no card it raises).  It
wires config -> model -> data (``data.lm_data``, each batch moved to the
device) -> ``train.loop.Trainer`` (checkpoint, restart, straggler
monitor), and retries through simulated failures (``--failure-rate``,
drawn from ``random.Random(seed)``) to show the restart path: each
restart rebuilds the params and resumes from the last checkpoint.
Weights are random, drawn from a generator seeded ``--seed`` on the
device.  ``--arch`` takes every name of ``configs``.
"""
from __future__ import annotations

import argparse
import dataclasses
import random

import torch

from repro_torch.configs.base import get_arch
from repro_torch.data import lm_data
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.train import loop as tl
from repro_torch.train import optimizer as opt_lib
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")


def main(argv=None) -> dict:
    """Runs the launcher -> {"steps", "restarts", "history"} (the metrics
    of every step run, restarts included)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "lion"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "sign1bit", "topk"])
    ap.add_argument("--remat", default="none",
                    choices=["none", "block", "dots"])
    ap.add_argument("--quant-mode", default=None,
                    choices=[None, "none", "ternary"],
                    help="override arch quant mode (paper's ternary regime)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--failure-rate", type=float, default=0.0,
                    help="probability per step of a simulated crash+restart")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    if args.quant_mode:
        cfg = dataclasses.replace(cfg, quant_mode=args.quant_mode)
    dev = ops.resolve_device(None, args.device)
    tcfg = tl.TrainConfig(
        opt=opt_lib.OptConfig(name=args.optimizer, lr=args.lr),
        microbatches=args.microbatches,
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        remat=args.remat,
        compression=args.compression,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    dcfg = lm_data.DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, microbatches=args.microbatches,
        frontend_tokens=(
            cfg.n_frontend_tokens or (args.seq if cfg.family == "encdec"
                                      else 0)
        ),
        frontend_dim=cfg.d_model,
    )

    def data(start):
        return (lm_data.to_device(b, dev)
                for b in lm_data.iterator(dcfg, start_step=start))

    rng = random.Random(args.seed)
    done = 0
    restarts = 0
    history: list = []
    while done < args.steps:
        params = api.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(
                args.seed), device=dev)
        trainer = tl.Trainer(cfg, tcfg, api.loss_fn(cfg, remat=args.remat),
                             params, data(0))
        # fast-forward the data to the restored step
        trainer.data_iter = data(trainer.step_idx)
        try:
            while trainer.step_idx < args.steps:
                if args.failure_rate and rng.random() < args.failure_rate:
                    raise RuntimeError("simulated node failure")
                h = trainer.run(1)
                history += h
                m = h[-1]
                if m["step"] % 10 == 0 or m["step"] == 1:
                    log.info("step %4d loss %.4f (%.2fs)", m["step"],
                             m["loss"], m["step_time_s"])
            done = trainer.step_idx
        except RuntimeError as e:
            restarts += 1
            log.warning("%s -> restarting from last checkpoint (restart #%d)",
                        e, restarts)
            if not tcfg.ckpt_dir:
                raise
    log.info("training complete: %d steps, %d restarts survived on %s",
             done, restarts, dev)
    return {"steps": done, "restarts": restarts, "history": history}


if __name__ == "__main__":
    main()
