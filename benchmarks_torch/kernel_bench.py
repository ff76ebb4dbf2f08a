"""Kernel micro-bench: the popcount GEMM (B.7) against the int8
tensor-core GEMM (B.8) at a decode-like and a batch-like shape.

Each row carries the bytes each path moves (the bitpacked path's 16x
weight compression), ``ops.pick_path``'s choice, and each kernel's time
per call on the card (CUDA events over ``repeats`` calls) beside the
card's name and power limit; every output is held bit for bit against
its plain version (the same entry point on CPU tensors).  It runs on the
card and raises when there is none; ``device="cpu"`` times the plain
versions on the host's clock, and every row names the device it timed.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks_torch.common import card, row, timed

SHAPES = ((1, 1024, 512, "decode-ish"), (256, 1024, 512, "batch-ish"))


def run(repeats: int = 20, device="cuda") -> list[str]:
    """The rows, timed on ``device``: the card (default; raises without
    one) or ``"cpu"``, the plain versions on the host's clock."""
    from repro_torch.kernels import ops

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_bench: no card (pass device='cpu' to "
                           "time the plain versions on the host)")
    host = dev.type != "cuda"
    where = "cpu, host clock, plain versions" if host else card()
    rows = []
    rng = np.random.default_rng(0)
    for m, k, n, tag in SHAPES:
        x = torch.from_numpy(rng.integers(0, 2, (m, k))).to(torch.int32)
        w = torch.from_numpy(rng.integers(-1, 2, (k, n))).to(torch.int32)
        thr = torch.zeros(n, dtype=torch.float32)
        flip = torch.zeros(n, dtype=torch.bool)
        bytes_pop = m * k / 8 + 2 * k * n / 8
        bytes_mxu = m * k + k * n
        pick = ops.pick_path(m, k, n)
        plain = {"popcount": ops.twm_linear(x, w, thr, flip),
                 "mxu": ops.twm_linear_mxu(x, w, thr, flip)}
        args = [t.to(dev) for t in (x, w, thr, flip)]
        outs, us = {}, {}
        outs["popcount"], us["popcount"] = timed(
            ops.twm_linear, *args, repeats=repeats, host_clock=host)
        outs["mxu"], us["mxu"] = timed(
            ops.twm_linear_mxu, *args, repeats=repeats,
            host_clock=host)
        for path, out in outs.items():
            if not torch.equal(out.cpu(), plain[path]):
                raise RuntimeError(f"kernel.{tag}.{path}: the output "
                                   "differs from its plain version")
        rows.append(row(
            f"kernel.{tag}.pick", pick,
            f"bytes_popcount={bytes_pop:.0f};bytes_mxu={bytes_mxu:.0f};"
            f"ratio={bytes_mxu / bytes_pop:.1f}x",
        ))
        for path, name in (("popcount", "B.7"), ("mxu", "B.8")):
            rows.append(row(f"kernel.{tag}.{dev.type}.us_{path}",
                            f"{us[path]:.3f}",
                            f"{name} ({m}x{k}x{n}) bit-equal to its plain "
                            f"version; {where}"))
    return rows
