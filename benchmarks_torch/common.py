"""Shared helpers for the port's benchmarks."""
from __future__ import annotations

import subprocess
import time

import torch


def compile_kws_full(device=None):
    """Compile the full Fig.-7 reconstruction once (shared by benches):
    random QAT weights from a generator seeded 0, exported and compiled
    for the chip twin on ``device`` (default: the card)."""
    from repro_torch.core import compiler
    from repro_torch.models import kws

    spec = kws.build_kws_spec()
    params = kws.init_kws_params(
        spec, generator=torch.Generator().manual_seed(0), device=device)
    weights, thresholds = kws.export_kws(params, spec)
    prog = compiler.compile_model(
        spec, weights, thresholds,
        rotate_hints=kws.ROTATE_HINTS, rowsplit_hints=kws.ROWSPLIT_HINTS,
        device=device,
    )
    return spec, params, prog


def timed(fn, *args, repeats: int = 3, host_clock: bool = False, **kw):
    """-> (the last output, us per call).  One warm-up call, then
    ``repeats`` calls timed by CUDA events (device time of the calls as
    issued); the output must lie on the card.  ``host_clock=True`` asks
    for the host's clock instead (a CPU run's plain versions), which is
    never a device time."""
    out = fn(*args, **kw)  # warm-up (and the first call's build)
    if host_clock:
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn(*args, **kw)
        return out, (time.perf_counter() - t0) / repeats * 1e6
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        raise RuntimeError("timed: the output is not on the card; pass "
                           "host_clock=True to time on the host")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn(*args, **kw)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / repeats * 1e3


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``no card``."""
    if not torch.cuda.is_available():
        return "no card"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def row(name: str, us_per_call: float | str, derived: str = "") -> str:
    return f"{name},{us_per_call},{derived}"
