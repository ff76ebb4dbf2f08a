"""Beyond-paper, on the PyTorch port: the PSCNN ternary regime applied to
an LM architecture.

Trains a reduced qwen3-family decoder twice -- fp baseline vs
quant_mode='ternary' (BitNet-style PSCNN linears, straight-through
gradients) -- through the port's training substrate (AdamW, grad
clipping, ``train.loop.Trainer``), and reports the loss gap, plus the
serve-time bytes saved by packed TWM planes (2 bits a weight).

Run:  PYTHONPATH=src python examples/lm_ternary_train_torch.py
          [--steps N] [--device cuda|cpu]
(the default device is the card.)
"""
import argparse
import dataclasses

import torch

from repro_torch.configs.base import get_arch
from repro_torch.data import lm_data
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.train import loop as tl
from repro_torch.train import optimizer as opt_lib
from repro_torch.utils.tree import tree_count_params, tree_size_bytes


def train(cfg, steps: int, device, seed: int = 0):
    tcfg = tl.TrainConfig(opt=opt_lib.OptConfig(lr=3e-3), remat="none",
                          warmup_steps=max(steps // 10, 1), total_steps=steps)
    dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                              seed=seed)
    params = api.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device)
    tr = tl.Trainer(cfg, tcfg, api.loss_fn(cfg, remat="none"), params,
                    (lm_data.to_device(b, device)
                     for b in lm_data.iterator(dcfg)))
    hist = tr.run(steps)
    return hist, tr.state["params"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(None, args.device)

    base_cfg = get_arch("qwen3-0.6b", smoke=True)
    tern_cfg = dataclasses.replace(base_cfg, quant_mode="ternary")

    print(f"== fp baseline ({dev}) ==")
    h_fp, params = train(base_cfg, args.steps, dev)
    print(f"loss {h_fp[0]['loss']:.4f} -> {h_fp[-1]['loss']:.4f}")

    print("== ternary (PSCNN regime) ==")
    h_t, _ = train(tern_cfg, args.steps, dev)
    print(f"loss {h_t[0]['loss']:.4f} -> {h_t[-1]['loss']:.4f}")
    gap = h_t[-1]["loss"] - h_fp[-1]["loss"]
    print(f"quantization loss gap: {gap:+.4f}")

    dense_bytes = tree_size_bytes(params)
    packed_bytes = tree_count_params(params) // 4   # TWM planes: 2 bits
    print(f"\nserve-time weights: dense bf16 {dense_bytes/1e6:.1f} MB -> "
          f"TWM planes {packed_bytes/1e6:.1f} MB "
          f"({dense_bytes/packed_bytes:.0f}x smaller)")
    return {"fp": h_fp, "ternary": h_t, "gap": gap,
            "dense_bytes": dense_bytes, "packed_bytes": packed_bytes}


if __name__ == "__main__":
    main()
