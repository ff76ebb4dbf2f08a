"""The LM paths' host-bound times on the card: Qwen3-0.6B (full width and
depth, random weights from ``--seed``) served by the continuous-batching
engine (decode tick and prefill p50) and trained by ``train.loop.Trainer``
(the median step, AdamW, remat ``block``).

The model code is whichever ``repro_torch`` is first on ``PYTHONPATH``,
so that two trees can be compared in one call on one card:

  PYTHONPATH=src python -m benchmarks_torch.lm_step --tag change
  PYTHONPATH=/path/to/other/src python -m benchmarks_torch.lm_step \\
      --tag parent

Prints ``name,value,derived`` rows, each beside the card's name and power
limit; needs a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks_torch.common import card, row

ARCH = "qwen3-0.6b"
REQUESTS, PROMPT, NEW, SLOTS, MAX_SEQ = 8, 16, 32, 4, 64
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 12, 8, 256


def serve_ms(cfg, params, seed: int) -> tuple[float, float, int]:
    """-> (decode tick p50 ms, prefill p50 ms, ticks) of one sync drain
    of ``REQUESTS`` requests through ``SLOTS`` slots."""
    from repro_torch.serve import engine

    eng = engine.Engine(cfg, params, max_seq=MAX_SEQ, batch_slots=SLOTS)
    rng = np.random.default_rng(seed)
    for i in range(REQUESTS):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, PROMPT).astype(np.int32),
            max_new_tokens=NEW))
    with torch.no_grad():
        done = eng.run_until_drained()
    if len(done) != REQUESTS:
        raise RuntimeError(f"lm_step: {len(done)} of {REQUESTS} requests")
    reg = eng.obs.registry
    tick = reg.histogram("serve.decode_tick_s")
    return (tick.quantile(0.5) * 1e3,
            reg.histogram("serve.prefill_s").quantile(0.5) * 1e3,
            tick.count)


def train_ms(cfg, params, seed: int, dev) -> float:
    """-> the median step ms of ``TRAIN_STEPS`` steps (the first left
    out) on batches staged on the card."""
    from repro_torch.data import lm_data
    from repro_torch.models import api
    from repro_torch.train import loop, optimizer

    dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=seed)
    batches = [lm_data.to_device(lm_data.batch_at(dcfg, i), dev)
               for i in range(TRAIN_STEPS)]
    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(lr=1e-3), remat="block",
                            warmup_steps=2, total_steps=TRAIN_STEPS)
    trainer = loop.Trainer(cfg, tcfg, api.loss_fn(cfg, tcfg.remat), params,
                           iter(batches))
    torch.cuda.synchronize()
    hist = trainer.run(TRAIN_STEPS)
    losses = [h["loss"] for h in hist]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"lm_step: non-finite losses {losses}")
    return float(np.median([h["step_time_s"] * 1e3 for h in hist[1:]]))


def run(tag: str = "", seed: int = 0) -> list[str]:
    from repro_torch.configs import get_arch
    from repro_torch.models import api

    if not torch.cuda.is_available():
        raise RuntimeError("lm_step: no card")
    dev = torch.device("cuda", 0)
    cfg = get_arch(ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = api.init_params(cfg, generator=gen, device=dev)
    where = card()
    pre = f"lm_step{'.' + tag if tag else ''}"
    t0 = time.perf_counter()
    tick, prefill, ticks = serve_ms(cfg, params, seed)
    serve_s = time.perf_counter() - t0
    step = train_ms(cfg, params, seed, dev)
    return [
        row(f"{pre}.serve.decode_tick_ms_p50", f"{tick:.4f}",
            f"{ARCH} {SLOTS} slots, {ticks} sync ticks, drain "
            f"{serve_s:.2f} s; {where}"),
        row(f"{pre}.serve.prefill_ms_p50", f"{prefill:.4f}",
            f"{PROMPT}-token prompts; {where}"),
        row(f"{pre}.train.step_ms_median", f"{step:.4f}",
            f"{TRAIN_BATCH}x{TRAIN_SEQ} AdamW remat block, "
            f"{TRAIN_STEPS - 1} steps; {where}"),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for line in run(args.tag, args.seed):
        print(line, flush=True)


if __name__ == "__main__":
    main()
