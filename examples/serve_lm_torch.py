"""Serve an LM with batched requests through the PyTorch port's
continuous-batching engine (prefill -> slot install -> decode ticks ->
retire).  Random weights from a seeded generator.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch qwen3-0.6b]
      [--device cpu] [--full]

``--arch`` takes every config name (``repro_torch.configs.arch_names()``:
dense, VLM, MoE, SSM, hybrid and encoder-decoder).  Without ``--device``
it runs on the card (and raises with none);
``--full`` serves the published config instead of the reduced ``SMOKE``
one.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.serve.engine import Engine, Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()

    cfg = get_arch(args.arch, smoke=not args.full)
    dev = ops.resolve_device(None, args.device)
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    eng = Engine(cfg, params, batch_slots=args.slots, max_seq=64)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 10).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    done = eng.run_until_drained()
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"request {r.rid}: {r.out_tokens}")
    print(f"\n{len(done)} requests, {total} tokens, {dt:.1f}s "
          f"({total/dt:.1f} tok/s, {args.slots} slots continuous batching, "
          f"{cfg.name} on {dev})")


if __name__ == "__main__":
    main()
