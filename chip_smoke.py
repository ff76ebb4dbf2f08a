#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build, check and drive the KWS stream
hop on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line, any failure exits non-zero):

1. device   — a CUDA card must be present; its name and power limit.
2. build    — nvcc builds the hop kernel from ``src/repro_torch/kernels/
              csrc`` into ``build/``.
3. kernels  — the CUDA hop kernel (B.1, emit and steady) and its finalize
              mode (B.2) are bit-equal to their plain PyTorch versions on
              the card: the full-width KWS plan (``build_kws_spec()``,
              hop_frames=8) at B=256 with masked slots, at B=200, with a
              K=2 tenant pool, on the smoke spec and on three random
              streamable geometries.  Then each kernel and its plain
              version are timed with CUDA events at the main path's shape.
4. launches — one counted launch per hop (emit included) and per peek.
5. main     — ``StreamScheduler(build_kws_spec(), ..., capacity=256,
              hop_frames=8, backend="megakernel")``: 256 streams join,
              each gets 2 s of seeded audio in ragged chunks, the
              scheduler steps until starved, two peeks (one through a
              scheduler with ``emit_logits=False``, so the finalize kernel
              launches), 8 closes.  Every hop's logits equal a run with
              ``backend="torch"``; the closed streams' logits equal the
              numpy ``StreamState`` fed the same audio.

The model is made here from ``--seed`` with numpy: random ternary weights
and integer thresholds near the middle of each layer's accumulator range
with random flips.  The script imports nothing of JAX or of the reference
package.  Before its last line it prints one JSON object with each
kernel's launches on the main path, error, time, plain time and bound,
and the card's name and power limit as ``nvidia-smi`` reports them; the
last line is ``{"ok": true, "device": {...}}``.  The same record is
written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
B_MAIN = 256
HOP_FRAMES = 8


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Seeded model and inputs
# ---------------------------------------------------------------------------

def random_model(spec, seed: int):
    """Exported-model dicts: int8 ternary weights; float64 integer
    thresholds near the middle of the layer's accumulator range (a few
    channels at ±inf, as an exported a == 0 channel has), random flips."""
    from repro_torch.core.cnn_spec import Conv1DSpec, FCSpec

    rng = np.random.default_rng(seed)
    weights, thresholds = {}, {}
    for li, lay in enumerate(spec.layers):
        if isinstance(lay, Conv1DSpec):
            shape = (lay.k * lay.cin, lay.cout)
        elif isinstance(lay, FCSpec):
            shape = (lay.cin, lay.cout)
        else:
            continue
        w = rng.choice(np.array([-1, 0, 1], np.int8), size=shape)
        if isinstance(lay, Conv1DSpec) and lay.in_bits > 1:
            lo, hi = -lay.in_offset, (1 << lay.in_bits) - 1 - lay.in_offset
        elif isinstance(lay, FCSpec) and lay.in_bits > 1:
            lo, hi = 0, 255          # saturated GAP counts
        else:
            lo, hi = 0, 1            # binary activations
        mid = (lo + hi) / 2 * w.sum(0)
        spread = (hi - lo) / 4 * np.sqrt(np.abs(w).sum(0) + 1)
        thr = np.round(mid + rng.uniform(-0.5, 0.5, lay.cout) * spread)
        inf = rng.random(lay.cout) < 0.02
        thr[inf] = np.where(rng.random(inf.sum()) < 0.5, -np.inf, np.inf)
        flip = rng.random(lay.cout) < 0.25
        weights[li] = w
        thresholds[li] = (thr.astype(np.float64), flip)
    return weights, thresholds


def random_spec(seed: int):
    """A small random streamable spec (bit-serial first layer with random
    k/stride/pad, 1-2 conv blocks with random k/pad/pool, GAP, binary fc,
    raw fc) and a hop_frames that reaches a steady state."""
    from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
    from repro_torch.stream.state import plan_stream

    rng = np.random.default_rng(seed)
    while True:
        k0 = int(rng.integers(3, 13))
        bits0 = int(rng.choice([4, 8]))
        layers = [Conv1DSpec(1, int(rng.choice([4, 8, 32])), k=k0,
                             stride=int(rng.choice([2, 4, 8])),
                             pad=int(rng.integers(0, k0)), in_bits=bits0,
                             in_offset=1 << (bits0 - 1), name="l0")]
        cin = layers[0].cout
        for j in range(int(rng.integers(1, 4))):
            k = int(rng.choice([3, 5]))
            cout = int(rng.choice([4, 8, 48, 96]))
            layers.append(Conv1DSpec(cin, cout, k=k,
                                     pad=int(rng.integers(0, k // 2 + 1)),
                                     pool=int(rng.choice([1, 2, 2, 4])),
                                     name=f"b{j + 1}"))
            cin = cout
        layers += [GAPSpec(cin, name="gap"),
                   FCSpec(cin, 16, in_bits=8, name="fc1"),
                   FCSpec(16, 12, out_raw=True, name="fc2")]
        spec = CNN1DSpec(in_len=4000, in_channels=1, in_bits=bits0,
                         layers=tuple(layers), name=f"rand{seed}")
        for hf in (1, 2, 3, 4, 6, 8):
            try:
                plan_stream(spec, hop_frames=hf)
            except ValueError:
                continue
            return spec, hf


def model_tensors(plan, weights, thresholds, device, torch):
    """The kernel's operand layout of one model (int8 weights)."""
    def put(x, dt):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    st, fc = plan.convs, plan.fcs
    return dict(
        ws=[put(weights[s.layer_idx].reshape(s.k, s.cin, s.cout),
                torch.int8) for s in st],
        thrs=[put(thresholds[s.layer_idx][0], torch.float32) for s in st],
        flips=[put(thresholds[s.layer_idx][1], torch.int32) for s in st],
        fc_ws=[put(weights[f.layer_idx], torch.int8) for f in fc],
        fc_thrs=[put(thresholds[f.layer_idx][0], torch.float32) for f in fc],
        fc_flips=[put(thresholds[f.layer_idx][1], torch.int32) for f in fc],
    )


def hop_inputs(plan, b, seed, device, torch, mask_zeros=True):
    """Packed hop operands: audio codes, mask, state (non-zero-width)."""
    rng = np.random.default_rng(seed)
    st = plan.convs
    put = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    mask = (rng.random(b) < (0.8 if mask_zeros else 1.1)).astype(np.int32)
    return dict(
        audio=put(rng.integers(0, 256, (b, plan.hop_samples, st[0].cin),
                               dtype=np.int32)),
        mask=put(mask),
        tails=tuple(put(rng.integers(0, 256 if i == 0 else 2,
                                     (b, s.tail, s.cin), dtype=np.int32))
                    for i, s in enumerate(st) if s.tail),
        pendings=tuple(put(rng.integers(0, 2, (b, s.phase, s.cout),
                                        dtype=np.int32))
                       for s in st if s.phase),
        gap=put(rng.integers(0, 256, (b, plan.gap_channels),
                             dtype=np.int32)),
    )


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_case(label, plan, params, inp, model_idx, torch, mk, dispatch):
    """Kernel vs plain on one case: B.1 emit, B.1 steady, B.2.  Returns
    the max |kernel - plain| per kernel (int32, so 0 when bit-equal)."""
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    p = (params["ws"], params["thrs"], params["flips"], params["fc_ws"],
         params["fc_thrs"], params["fc_flips"])
    err = {mk.HOP_KERNEL: 0, mk.FINALIZE_KERNEL: 0}
    for emit in (True, False):
        args = (inp["audio"], inp["mask"], inp["tails"], inp["pendings"],
                inp["gap"], *p, model_idx)
        with dispatch.counting() as launched:
            got = mk.hop_megakernel_packed(*args, geoms=geoms, emit=emit,
                                           fc_raw=fc_raw)
        if launched() != {mk.HOP_KERNEL: 1}:
            raise RuntimeError(f"{label}: hop wrapper launched {launched()}")
        want = mk.hop_megakernel_plain(*args, geoms=geoms, emit=emit,
                                       fc_raw=fc_raw)
        torch.cuda.synchronize()
        flat_got = [*got[0], *got[1], got[2]] + ([got[3]] if emit else [])
        flat_want = [*want[0], *want[1], want[2]] + ([want[3]] if emit
                                                     else [])
        for g, w in zip(flat_got, flat_want):
            if g.dtype != torch.int32 or g.shape != w.shape:
                raise RuntimeError(f"{label}: output {g.dtype} {g.shape} "
                                   f"vs {w.dtype} {w.shape}")
            e = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            err[mk.HOP_KERNEL] = max(err[mk.HOP_KERNEL], e)
    fargs = (inp["tails"], inp["pendings"], inp["gap"], *p, model_idx)
    got = mk.finalize_megakernel_packed(*fargs, geoms=geoms, fc_raw=fc_raw)
    want = mk.finalize_megakernel_plain(*fargs, geoms=geoms, fc_raw=fc_raw)
    torch.cuda.synchronize()
    err[mk.FINALIZE_KERNEL] = int((got.long() - want.long()).abs().max())
    bad = {k: v for k, v in err.items() if v}
    if bad:
        raise RuntimeError(f"{label}: kernel disagrees with plain: {bad}")
    phase("kernels", f"{label}: B={inp['gap'].shape[0]} bit-equal "
          f"(hop emit+steady, finalize)")
    return err


def time_ms(fn, torch, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(plan, params, inp, b, *, finalize: bool, emit: bool):
    """Least time for the same work on an H100: the larger of the bytes
    moved (each input read once, each output written once) over HBM rate
    and the int8 ops (2 per MAC) over the int8 tensor-core peak."""
    macs = 0
    for s in plan.convs:
        per = s.k * s.cin * s.cout
        if not finalize:
            macs += s.n_conv * per
        if finalize or emit:
            macs += s.flush_conv * per
    if finalize or emit:
        macs += sum(f.cin * f.cout for f in plan.fcs)
    macs *= b
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731,E501
    weights = nbytes(params["ws"] + params["thrs"] + params["flips"])
    fc = nbytes(params["fc_ws"] + params["fc_thrs"] + params["fc_flips"])
    state = nbytes(list(inp["tails"]) + list(inp["pendings"]) + [inp["gap"]])
    n_cls = plan.fcs[-1].cout
    if finalize:
        total = state + weights + fc + b * n_cls * 4
    else:
        total = (nbytes([inp["audio"], inp["mask"]]) + 2 * state + weights
                 + ((fc + b * n_cls * 4) if emit else 0))
    t_bytes = total / HBM_BYTES_PER_S
    t_ops = 2 * macs / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------

def drive(sched, audio, chunk_plan, hop, torch):
    """256 streams join, get their audio in ragged chunks, the scheduler
    steps until starved; stream 0 is topped up to a hop boundary; two
    peeks; 8 closes.  Returns per-hop records, peeks, closes, hop times."""
    n = len(audio)
    for sid in range(n):
        sched.add_stream(sid)
    hops, hop_ms = [], []
    fed = [0] * n

    def step_all():
        while True:
            t0 = time.perf_counter()
            hb = sched.step_batch()  # ends in a device synchronize
            if hb is None:
                return
            hop_ms.append((time.perf_counter() - t0) * 1e3)
            hops.append((hb.sids.copy(), hb.frames.copy(),
                         None if hb.logits is None else hb.logits.copy()))

    for sizes in chunk_plan:
        sids = [s for s in range(n) if sizes[s]]
        chunks = [audio[s][fed[s]:fed[s] + sizes[s]] for s in sids]
        for s in sids:
            fed[s] += sizes[s]
        sched.push_audio_batch(sids, chunks)
        step_all()
    left = len(sched._streams[0].frontend)
    top = np.full(hop - left, 128, np.uint8)
    sched.push_audio(0, top)
    step_all()
    assert len(sched._streams[0].frontend) == 0
    peeks = {0: sched.peek(0), 1: sched.peek(1)}
    closes = {sid: sched.close_stream(sid) for sid in range(0, 256, 32)}
    return hops, peeks, closes, hop_ms, top


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, dispatch
        from repro_torch.kernels import hop_megakernel as mk
        from repro_torch.models import kws
        from repro_torch.stream import StreamScheduler, StreamState
        from repro_torch.stream.state import plan_stream
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    card = card_line()
    dev = torch.device("cuda", 0)
    phase("device", f"{torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib = build.build(mk.HOP_KERNEL)
    ptxas = [ln.strip() for ln in build.build_logs.get(mk.HOP_KERNEL,
                                                        "").splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"{lib.name} in {time.perf_counter() - t0:.2f} s; "
          + " | ".join(ptxas))

    # 3. kernels vs plain
    spec = kws.build_kws_spec()
    plan = plan_stream(spec, hop_frames=HOP_FRAMES)
    weights, thresholds = random_model(spec, args.seed)
    params = model_tensors(plan, weights, thresholds, dev, torch)
    err = {mk.HOP_KERNEL: 0, mk.FINALIZE_KERNEL: 0}

    def merge(e):
        for k, v in e.items():
            err[k] = max(err[k], v)

    main_inp = hop_inputs(plan, B_MAIN, args.seed + 1, dev, torch)
    merge(check_case("kws hf8 masked", plan, params, main_inp, None, torch,
                     mk, dispatch))
    merge(check_case("kws hf8 B=200", plan, params,
                     hop_inputs(plan, 200, args.seed + 2, dev, torch),
                     None, torch, mk, dispatch))
    w2, t2 = random_model(spec, args.seed + 100)
    p2 = model_tensors(plan, w2, t2, dev, torch)
    pooled = {k: [torch.stack([a, b]) for a, b in zip(params[k], p2[k])]
              for k in params}
    blocks = np.random.default_rng(args.seed).integers(0, 2, B_MAIN // 8)
    model_idx = torch.as_tensor(np.repeat(blocks, 8).astype(np.int32),
                                device=dev)
    merge(check_case("kws hf8 pooled K=2", plan, pooled, main_inp,
                     model_idx, torch, mk, dispatch))
    smoke = kws.build_kws_smoke_spec()
    splan = plan_stream(smoke, hop_frames=1)
    merge(check_case("smoke hf1", splan,
                     model_tensors(splan, *random_model(smoke, args.seed),
                                   dev, torch),
                     hop_inputs(splan, 64, args.seed + 3, dev, torch),
                     None, torch, mk, dispatch))
    for j in range(3):
        rspec, hf = random_spec(args.seed * 10 + j)
        rplan = plan_stream(rspec, hop_frames=hf)
        merge(check_case(
            f"random geometry {j} ({len(rplan.convs)} convs, hf {hf})",
            rplan, model_tensors(rplan, *random_model(rspec, j), dev, torch),
            hop_inputs(rplan, 48, args.seed + 10 + j, dev, torch), None,
            torch, mk, dispatch))

    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    p = (params["ws"], params["thrs"], params["flips"], params["fc_ws"],
         params["fc_thrs"], params["fc_flips"])
    full = hop_inputs(plan, B_MAIN, args.seed + 4, dev, torch,
                      mask_zeros=False)  # every slot advances, as on a hop
    hop_args = (full["audio"], full["mask"], full["tails"], full["pendings"],
                full["gap"], *p)
    fin_args = (full["tails"], full["pendings"], full["gap"], *p)
    timing = {}
    for emit in (True, False):
        timing[("hop", emit)] = (
            time_ms(lambda: mk.hop_megakernel_packed(
                *hop_args, geoms=geoms, emit=emit, fc_raw=fc_raw), torch),
            time_ms(lambda: mk.hop_megakernel_plain(
                *hop_args, geoms=geoms, emit=emit, fc_raw=fc_raw), torch,
                iters=5),
            *bound_ms(plan, params, full, B_MAIN, finalize=False, emit=emit))
    timing["fin"] = (
        time_ms(lambda: mk.finalize_megakernel_packed(
            *fin_args, geoms=geoms, fc_raw=fc_raw), torch),
        time_ms(lambda: mk.finalize_megakernel_plain(
            *fin_args, geoms=geoms, fc_raw=fc_raw), torch, iters=5),
        *bound_ms(plan, params, full, B_MAIN, finalize=True, emit=True))
    for key, (ms, pms, bms, by) in timing.items():
        phase("kernels", f"time {key}: kernel {ms:.4f} ms, plain {pms:.4f} "
              f"ms, bound {bms:.6f} ms ({by}) at B={B_MAIN} hf={HOP_FRAMES}")

    # 4. launch counts: one per hop (emit included), one per peek
    for emit in (True, False):
        s = StreamScheduler(smoke, *random_model(smoke, 7), capacity=4,
                            hop_frames=1, emit_logits=emit)
        a = s.add_stream()
        s.push_audio(a, np.random.default_rng(7).integers(
            0, 256, splan.prime_samples + 3 * splan.hop_samples,
            dtype=np.uint8))
        dispatch.reset()
        n_hops = s.drain()
        hops_counted = dispatch.counts()
        dispatch.reset()
        s.peek(a)
        peek_counted = dispatch.counts()
        want_peek = {} if emit else {mk.FINALIZE_KERNEL: 1}
        if (hops_counted != {mk.HOP_KERNEL: n_hops} or n_hops != 3
                or peek_counted != want_peek):
            raise RuntimeError(f"launch counts (emit={emit}): {n_hops} hops "
                               f"-> {hops_counted}, peek -> {peek_counted}")
        phase("launches", f"emit={emit}: {n_hops} hops -> {hops_counted}, "
              f"hop-boundary peek -> {peek_counted or 'cached logits'}")

    # 5. the main path
    rng = np.random.default_rng(args.seed + 5)
    audio = [rng.integers(0, 256, 32000, dtype=np.uint8)
             for _ in range(B_MAIN)]
    chunk_plan, fed = [], np.zeros(B_MAIN, np.int64)
    while (fed < 32000).any():
        sizes = np.minimum(rng.integers(200, 2400, B_MAIN), 32000 - fed)
        sizes[rng.random(B_MAIN) < 0.15] = 0   # some streams skip a round
        fed += sizes
        chunk_plan.append(sizes.tolist())
    kw = dict(capacity=B_MAIN, hop_frames=HOP_FRAMES)
    dispatch.reset()   # the main path's counts start here
    mega = StreamScheduler(spec, weights, thresholds, backend="megakernel",
                           **kw)
    hops, peeks, closes, hop_ms, top = drive(mega, audio, chunk_plan,
                                             plan.hop_samples, torch)
    quiet = StreamScheduler(spec, weights, thresholds, backend="megakernel",
                            emit_logits=False, **kw)
    q_hops, q_peeks, q_closes, _, _ = drive(quiet, audio, chunk_plan,
                                            plan.hop_samples, torch)
    launches = dispatch.counts()
    dense = StreamScheduler(spec, weights, thresholds, backend="torch", **kw)
    d_hops, d_peeks, d_closes, _, _ = drive(dense, audio, chunk_plan,
                                            plan.hop_samples, torch)
    if launches.get(mk.HOP_KERNEL) != len(hops) + len(q_hops):
        raise RuntimeError(f"hop launches {launches} != hops "
                           f"{len(hops)} + {len(q_hops)}")
    if launches.get(mk.FINALIZE_KERNEL) != 1:
        raise RuntimeError(f"finalize launches {launches}: the emit-off "
                           "hop-boundary peek must launch it once")
    if len(hops) != len(d_hops) or len(hops) != len(q_hops):
        raise RuntimeError("hop counts differ between runs")
    for (s1, f1, l1), (s2, f2, l2), (s3, f3, _) in zip(hops, d_hops, q_hops):
        if not (np.array_equal(s1, s2) and np.array_equal(s1, s3)
                and np.array_equal(f1, f2) and np.array_equal(f1, f3)
                and np.array_equal(l1, l2)):
            raise RuntimeError("megakernel hop differs from dense backend")
    for sid in peeks:
        if not (np.array_equal(peeks[sid], d_peeks[sid])
                and np.array_equal(peeks[sid], q_peeks[sid])):
            raise RuntimeError(f"peek({sid}) differs between runs")
    for sid, res in closes.items():
        oracle = StreamState(plan, weights, thresholds)
        clip = audio[sid] if sid else np.concatenate([audio[0], top])
        oracle.advance(clip, flush=True)
        want = oracle.logits()
        for other in (d_closes[sid], q_closes[sid]):
            if not np.array_equal(res.logits, other.logits):
                raise RuntimeError(f"close({sid}) differs between runs")
        if not np.array_equal(res.logits, want):
            raise RuntimeError(f"close({sid}) differs from StreamState")
    all_logits = np.concatenate([h[2] for h in hops])
    if not np.isfinite(all_logits).all() or all_logits.shape[1] != 12:
        raise RuntimeError(f"bad logits {all_logits.shape}")
    if len(np.unique(all_logits, axis=0)) < 2:
        raise RuntimeError("every hop gave the same logits")
    p50 = float(np.percentile(hop_ms, 50))
    phases = {k: v["ms_p50"] for k, v in mega.metrics.phase_summary().items()}
    phase("main", f"{len(hops)} hops over {B_MAIN} streams (+ emit-off run "
          f"{len(q_hops)} hops), 2 peeks, {len(closes)} closes; hop p50 "
          f"{p50:.3f} ms synchronised; hop kernel {timing[('hop', True)][0]:.4f}"
          f" ms, finalize kernel {timing['fin'][0]:.4f} ms per launch; "
          f"logits == torch backend == StreamState; launches {launches}; "
          f"phase p50 ms {phases}; {card}")

    ms, pms, bms, by = timing[("hop", True)]
    fms, fpms, fbms, fby = timing["fin"]
    kernels = {"kernels": [
        {"name": mk.HOP_KERNEL, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hop_megakernel.cu",
         "replaces": "src/repro/kernels/hop_megakernel.py:438",
         "launches": launches.get(mk.HOP_KERNEL, 0),
         "max_abs_err": err[mk.HOP_KERNEL], "ms": ms, "plain_ms": pms,
         "bound_ms": bms, "bound_by": by, "library_ms": None},
        {"name": mk.FINALIZE_KERNEL, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hop_megakernel.cu",
         "replaces": "src/repro/kernels/hop_megakernel.py:534",
         "launches": launches.get(mk.FINALIZE_KERNEL, 0),
         "max_abs_err": err[mk.FINALIZE_KERNEL], "ms": fms,
         "plain_ms": fpms, "bound_ms": fbms, "bound_by": fby,
         "library_ms": None},
    ]}
    record = dict(kernels, card=card, hop_ms_p50=p50, hops=len(hops),
                  phase_ms_p50=phases,
                  steady_hop=dict(zip(("ms", "plain_ms", "bound_ms",
                                       "bound_by"),
                                      timing[("hop", False)])))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
