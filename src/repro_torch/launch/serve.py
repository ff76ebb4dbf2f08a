"""Serving launcher: batched engine with continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --requests 8 --slots 4 --max-new 16 --device cpu

``--arch`` takes every name of ``configs`` (every family: dense, vlm,
moe, ssm, hybrid, encdec).  The port of the reference's
``repro/launch/serve.py``, with ``--device``
(default ``cuda``: the card; with no card it raises).  Weights are random,
drawn from a generator seeded ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.serve.engine import Engine, Request
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    dev = ops.resolve_device(None, args.device)
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    eng = Engine(cfg, params, batch_slots=args.slots, max_seq=args.max_seq)

    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    done = eng.run_until_drained()
    dt = time.monotonic() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s) on %s",
             len(done), n_tok, dt, n_tok / dt, dev)
    for r in done[:4]:
        log.info("request %d -> %s", r.rid, r.out_tokens[:8])


if __name__ == "__main__":
    main()
