"""The MoE dispatch's CUDA kernels (``kernels/moe_dispatch.py``) on the card
at the LM cells' layer shapes: the four kernels' device time (CUDA events
over many calls, and each kernel's share from the profiler), the byte
bound of a call, the plain ``route`` + ``dispatch_dropping`` on the card,
and ``torch.bmm`` of the same buckets (the library's time for the
experts' products), and the host's time to issue a layer.

    PYTHONPATH=src python -m benchmarks_torch.moe_dispatch

Random weights at published widths (DeepSeek-MoE-16B: E 64, top-6, D 2048,
F 1408, 32 tokens; AI21-Jamba2-Mini: 8 of 16 experts held, top-2, D 4096,
F 14336, 64 tokens), no shared experts.  Prints ``name,value,derived``
rows beside the card's name and power limit; needs a card.
"""
from __future__ import annotations

import argparse
import time

import torch

from benchmarks_torch.common import card, row as _row
from repro_torch.kernels import moe_dispatch as md
from repro_torch.models import layers, moe

#: name -> (N, K, E, D, F, held, renorm)
SHAPES = {
    "deepseek_b32": (32, 6, 64, 2048, 1408, None, True),
    "deepseek_b1": (1, 6, 64, 2048, 1408, None, True),
    "jamba_b64": (64, 2, 16, 4096, 14336, (0, 8), False),
    "jamba_b1": (1, 2, 16, 4096, 14336, (0, 8), False),
}
HBM_BYTES_S = 3.35e12


def row(*a) -> None:
    print(_row(*a), flush=True)


def _layer(n, k, e, d, f, held, seed, dev):
    g = torch.Generator().manual_seed(seed)
    n_held = e if held is None else held[1] - held[0]
    p = moe.init_moe(g, d, f, e, 0, device="cpu", n_held=n_held)
    p = {kk: v.to(dev) for kk, v in p.items()}
    x = torch.randn(n, 1, d, generator=g).to(dev)
    return p, x


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _kernel_ms(fn, reps: int) -> dict:
    """Each kernel's device ms a call, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t and ev.count:
            out[ev.key] = t / 1e3 / reps
    return out


def _bytes(n, k, e, d, f, held) -> int:
    """Bytes a call must move: the held experts' weights, the router, x
    and the output read or written once."""
    e_held = e if held is None else held[1] - held[0]
    return 3 * e_held * d * f * 2 + d * e * 4 + 2 * n * d * 4


def measure(name: str, reps: int, seed: int) -> None:
    n, k, e, d, f, held, renorm = SHAPES[name]
    dev = torch.device("cuda", 0)
    p, x = _layer(n, k, e, d, f, held, seed, dev)
    share = moe._share(p, held)
    cap = md.capacity(n, k, e, 1.25)
    e_held = p["wi_gate"].shape[0]
    pl = md.plan(e_held, cap, d, f, n * k)

    def kernels():
        return md._launch(p, x, top_k=k, cap=cap, share=share,
                          renorm=renorm).out

    def plain():
        """``apply_moe`` with the kernels refused: route +
        dispatch_dropping."""
        engages, md.engages = md.engages, lambda *a, **kw: False
        try:
            with layers.lm_precision():
                return moe.apply_moe(p, x, top_k=k, held=held,
                                     renorm=renorm)[0]
        finally:
            md.engages = engages

    xe = torch.randn(e_held, cap, d, device=dev).to(torch.bfloat16)

    def library():
        g = torch.bmm(xe, p["wi_gate"])
        u = torch.bmm(xe, p["wi_up"])
        h = torch.nn.functional.silu(g.float()).to(torch.bfloat16) * u
        return torch.bmm(h, p["wo"])

    def host_us(fn, reps_: int) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps_):
            fn()
        t = (time.perf_counter() - t0) / reps_ * 1e6
        torch.cuda.synchronize()
        return t

    def layer():
        return moe.apply_moe(p, x, top_k=k, held=held, renorm=renorm)[0]

    bound = _bytes(n, k, e, d, f, held) / HBM_BYTES_S * 1e3
    ms = _events_ms(kernels, reps)
    tag = f"moe_dispatch.{name}"
    row(f"{tag}.plan", 0, f"mt={pl.mt} route={pl.route_splits}x"
        f"{pl.route_rows} C={cap}")
    row(f"{tag}.kernels_ms", ms, f"bound {bound:.4f} ms "
        f"({bound / ms * 100:.1f} % of the byte bound)")
    for kname, kms in sorted(_kernel_ms(kernels, reps).items()):
        row(f"{tag}.kernel.{kname[:48]}", kms, "device ms a call")
    row(f"{tag}.plain_ms", _events_ms(plain, max(3, reps // 10)),
        "route + dispatch_dropping, events (host-bound)")
    row(f"{tag}.library_ms", _events_ms(library, reps),
        "torch.bmm x3 + silu on the same buckets")
    row(f"{tag}.host_us.apply_moe", host_us(layer, reps),
        "host us to issue one layer's apply_moe (the kernels)")
    row(f"{tag}.host_us.engages", host_us(
        lambda: md.engages(p, x, k), reps), "host us of the engage rule")
    row(f"{tag}.host_us.plain", host_us(plain, max(3, reps // 10)),
        "host us to issue route + dispatch_dropping")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", nargs="*", default=sorted(SHAPES))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    print(card())
    for name in a.shapes:
        measure(name, a.reps, a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
