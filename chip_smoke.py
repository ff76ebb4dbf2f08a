#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build, check and drive the KWS stream
hop on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line, any failure exits non-zero):

1. device   — a CUDA card must be present; its name and power limit.
2. build    — nvcc builds ``hop_megakernel.cu`` and ``bnn_conv1d.cu``
              from ``src/repro_torch/kernels/csrc`` into ``build/``, one
              compiler process each, started together.
3. kernels  — the CUDA hop kernel (B.1, emit and steady) and its finalize
              mode (B.2) are bit-equal to their plain PyTorch versions on
              the card: the full-width KWS plan (``build_kws_spec()``,
              hop_frames=8) at B=256 with masked slots, at B=200, with a
              K=2 tenant pool, on the smoke spec, on the smoke spec with an
              8-bit input to conv stage 1, and on three random streamable
              geometries.  The per-stage kernels — B.3 bit-serial step,
              B.4 conv step (raw, and ``sa`` with pool 1 and 2) and B.5
              classifier tail — are bit-equal to theirs at every launch
              shape of a KWS emit hop at B=256 and B=200, with a K=2 pool
              (B.3, B.4 raw, B.5), and on a random geometry.  Then each
              kernel and its plain version are timed at the main path's
              shapes (device time: CUDA events around replays of a CUDA
              graph of 20 calls; the time per call issued from Python is
              recorded beside it), and B.3 and B.4 raw beside the one
              PyTorch call that computes the same raw conv
              (``torch.nn.functional.conv1d``, float32, TF32 off: exact,
              every partial sum is below 2^24).
4. launches — megakernel: one counted launch per hop (emit included) and
              per peek; per-stage on the KWS plan: 4 per steady hop, 9
              per emit hop, 5 per hop-boundary peek.
5. main     — ``StreamScheduler(build_kws_spec(), ..., capacity=256,
              hop_frames=8)``: 256 streams join, each gets 2 s of seeded
              audio in ragged chunks, the scheduler steps until starved,
              two peeks, 8 closes; run with ``backend="megakernel"`` (and
              again with ``emit_logits=False``, so the finalize kernel
              launches on a peek), with ``backend="per_stage"`` and with
              ``backend="torch"``.  Every hop's logits agree across the
              three backends; the closed streams' logits equal the numpy
              ``StreamState`` fed the same audio.  The launch counters are
              set to 0 just before the megakernel runs and the per-stage
              run and read just after each.

The model is made here from ``--seed`` with numpy: random ternary weights
and integer thresholds near the middle of each layer's accumulator range
with random flips.  The script imports nothing of JAX or of the reference
package.  Before its last line it prints one JSON object with each
kernel's launches on the main path, error, time, plain time, bound and
library-call time (for the conv step: the sum over its three launches of
a hop), and the card's name and power limit as ``nvidia-smi`` reports
them; the last line is ``{"ok": true, "device": {...}}``.  The same record is
written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
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
        tails=tuple(put(rng.integers(0, 256 if s.in_bits > 1 else 2,
                                     (b, s.tail, s.cin), dtype=np.int32))
                    for s in st if s.tail),
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


def time_ms(fn, torch, iters=20, warmup=3, reps=5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's cost of
    issuing a call (Python, the wrapper's checks, ctypes) does not bound a
    kernel shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def call_ms(fn, torch, iters=20, warmup=3) -> float:
    """Time per call issued back to back from Python, between CUDA events:
    the larger of the device time and the host's cost of issuing it."""
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
# Phase 3, per-stage kernels (B.3-B.5)
# ---------------------------------------------------------------------------

def multibit_smoke_spec():
    """The smoke spec with conv stage 1 taking an 8-bit offset-binary input
    instead of binary maps (``ROADMAP.md`` C.1)."""
    from repro_torch.models import kws

    spec = kws.build_kws_smoke_spec()
    layers = list(spec.layers)
    layers[1] = dataclasses.replace(layers[1], in_bits=8, in_offset=128)
    return dataclasses.replace(spec, layers=tuple(layers),
                               name="smoke-multibit-b1")


def per_stage_launches(plan, models, b, seed, device, torch,
                       model_idx=None):
    """Every per-stage launch of one emit hop at the plan's shapes, on
    seeded windows and the given models' weights: per conv stage its hop
    window and, where ``flush_conv > 0``, its flush window (B.3 for a
    multi-bit input, else B.4 raw; unpooled, B.4 ``sa`` with pool 1 and 2
    on the hop window too), then the classifier (B.5).  ``models`` holds
    one ``model_tensors`` dict per tenant.  Each entry carries the
    kernel's prepared operands, its MAC count and whether the per-stage
    main path launches it at these shapes on every hop (``main``)."""
    from repro_torch.kernels import bnn_conv1d as bk
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    pooled = model_idx is not None

    def stack(xs):
        return torch.stack(list(xs)) if pooled else xs[0]

    out = []
    for i, s in enumerate(plan.convs):
        cw = ops.conv_weights(stack([m["ws"][i] for m in models]))
        for what, rows, n_pos in (
                ("hop", s.tail + s.n_in, s.n_conv),
                ("flush", s.tail + s.flush_in + s.pad, s.flush_conv)):
            if n_pos <= 0:
                continue
            macs = b * n_pos * s.cout * s.k * s.cin
            kw = dict(stride=s.stride, l_out=n_pos)
            if s.in_bits > 1:
                x = torch.as_tensor(rng.integers(0, 256, (b, rows, s.cin),
                                                 dtype=np.int32),
                                    device=device)
                out.append(dict(label=f"{what} l{i}",
                                name=bk.BITSERIAL_KERNEL,
                                args=(x, cw.w, model_idx),
                                kw=dict(bits=s.in_bits, **kw), macs=macs,
                                cin=s.cin, main=what == "hop"))
                continue
            xq = ops.pack_activations(torch.as_tensor(
                rng.integers(0, 2, (b, rows, s.cin), dtype=np.int32),
                device=device)).contiguous()
            out.append(dict(label=f"{what} b{i} raw",
                            name=bk.CONV_STEP_KERNEL,
                            args=(xq, cw.wp, cw.wn, None, None, model_idx),
                            kw=dict(k=s.k, mode="raw", **kw), macs=macs,
                            cin=s.cin, w=cw.w, main=what == "hop"))
            if what == "hop" and not pooled:
                for pool in (1, 2):
                    out.append(dict(
                        label=f"hop b{i} sa pool{pool}",
                        name=bk.CONV_STEP_KERNEL,
                        args=(xq, cw.wp, cw.wn, models[0]["thrs"][i],
                              models[0]["flips"][i], None),
                        kw=dict(k=s.k, mode="sa", pool=pool, **kw),
                        macs=macs, cin=s.cin, main=False))
    gap = torch.as_tensor(rng.integers(0, 300, (b, plan.gap_channels),
                                       dtype=np.int32), device=device)
    fc = {key: [stack([m[key][j] for m in models])
                for j in range(len(plan.fcs))]
          for key in ("fc_ws", "fc_thrs", "fc_flips")}
    out.append(dict(label="classifier", name=bk.TAIL_KERNEL,
                    args=(gap, fc["fc_ws"], fc["fc_thrs"], fc["fc_flips"],
                          model_idx),
                    kw=dict(out_raw=tuple(f.out_raw for f in plan.fcs)),
                    macs=b * sum(f.cin * f.cout for f in plan.fcs),
                    main=True))
    return out


def per_stage_fns(bk):
    """kernel name -> (kernel entry point, plain version)."""
    return {bk.BITSERIAL_KERNEL: (bk.bnn_bitserial_step,
                                  bk.bitserial_step_plain),
            bk.CONV_STEP_KERNEL: (bk.bnn_conv1d_step, bk.conv_step_plain),
            bk.TAIL_KERNEL: (bk.classifier_tail, bk.classifier_tail_plain)}


def check_per_stage(label, launches, torch, bk, dispatch):
    """Each per-stage kernel vs its plain version on the same operands on
    the card; returns the max |kernel - plain| per kernel name."""
    fns = per_stage_fns(bk)
    err = {}
    for e in launches:
        kernel, plain = fns[e["name"]]
        with dispatch.counting() as launched:
            got = kernel(*e["args"], **e["kw"])
        if launched() != {e["name"]: 1}:
            raise RuntimeError(f"{label} {e['label']}: launched "
                               f"{launched()}")
        want = plain(*e["args"], **e["kw"])
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"{label} {e['label']}: output {got.dtype} "
                               f"{tuple(got.shape)} vs {tuple(want.shape)}")
        d = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        err[e["name"]] = max(err.get(e["name"], 0), d)
        if d:
            raise RuntimeError(f"{label} {e['label']}: kernel disagrees "
                               f"with plain by {d}")
    phase("kernels", f"{label}: B={launches[-1]['args'][0].shape[0]} "
          f"bit-equal ({', '.join(e['label'] for e in launches)})")
    return err


def nbytes(xs) -> int:
    """Bytes of every tensor in a nest of tuples/lists (None skipped)."""
    if xs is None:
        return 0
    if isinstance(xs, (list, tuple)):
        return sum(nbytes(x) for x in xs)
    return xs.numel() * xs.element_size()


def launch_bound_ms(e, out) -> tuple[float, float, float]:
    """(bound ms, byte time, op time) of one per-stage launch: each input
    read once and the output written once over the HBM rate, against
    2 ops per MAC over the int8 tensor-core peak."""
    t_bytes = (nbytes(e["args"]) + nbytes(out)) / HBM_BYTES_PER_S
    t_ops = 2 * e["macs"] / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, t_bytes, t_ops


def library_call(e, torch):
    """The one PyTorch call computing a raw conv launch's function —
    ``conv1d`` in float32 (TF32 off) on the masked codes (B.3) or the
    unpacked bits (B.4) — as (callable, its output in the kernel's
    layout), operands made ahead of the timed call."""
    from repro_torch.core.quant import unpack_bits
    from repro_torch.kernels import bnn_conv1d as bk

    F = torch.nn.functional
    if e["name"] == bk.BITSERIAL_KERNEL:
        x, w, _ = e["args"]
        xf = (x & bk.code_mask(e["kw"]["bits"])).float()
    else:
        x, w = e["args"][0], e["w"]
        xf = unpack_bits(x)[..., :e["cin"]].float()
    xf = xf.permute(0, 2, 1).contiguous()            # (B, Cin, L)
    wf = w.float().permute(2, 1, 0).contiguous()      # (Cout, Cin, K)
    stride = e["kw"]["stride"]

    def call():
        return F.conv1d(xf, wf, stride=stride)
    return call, lambda y: y[..., :e["kw"]["l_out"]].permute(0, 2, 1)


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
        from repro_torch.kernels import bnn_conv1d as bk
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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build_all([mk.HOP_KERNEL, bk.SOURCE])
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in build.build_logs.get(name,
                                                            "").splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{lib.name}: " + " | ".join(ptxas))
    phase("build", f"{len(libs)} sources in {time.perf_counter() - t0:.2f} s")

    # 3. kernels vs plain
    spec = kws.build_kws_spec()
    plan = plan_stream(spec, hop_frames=HOP_FRAMES)
    weights, thresholds = random_model(spec, args.seed)
    params = model_tensors(plan, weights, thresholds, dev, torch)
    err = {mk.HOP_KERNEL: 0, mk.FINALIZE_KERNEL: 0, bk.BITSERIAL_KERNEL: 0,
           bk.CONV_STEP_KERNEL: 0, bk.TAIL_KERNEL: 0}

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
    for label, sp in (("smoke hf1", smoke),
                      ("smoke hf1, 8-bit input to conv stage 1 (C.1)",
                       multibit_smoke_spec())):
        pl = plan_stream(sp, hop_frames=1)
        merge(check_case(label, pl, model_tensors(
            pl, *random_model(sp, args.seed), dev, torch),
            hop_inputs(pl, 64, args.seed + 3, dev, torch), None, torch, mk,
            dispatch))
    rgeoms = []
    for j in range(3):
        rspec, hf = random_spec(args.seed * 10 + j)
        rplan = plan_stream(rspec, hop_frames=hf)
        rparams = model_tensors(rplan, *random_model(rspec, j), dev, torch)
        rgeoms.append((rplan, rparams))
        merge(check_case(
            f"random geometry {j} ({len(rplan.convs)} convs, hf {hf})",
            rplan, rparams, hop_inputs(rplan, 48, args.seed + 10 + j, dev,
                                       torch), None, torch, mk, dispatch))
    main_launches = per_stage_launches(plan, [params], B_MAIN, args.seed + 6,
                                       dev, torch)
    merge(check_per_stage("per-stage kws hf8", main_launches, torch, bk,
                          dispatch))
    merge(check_per_stage("per-stage kws hf8", per_stage_launches(
        plan, [params], 200, args.seed + 7, dev, torch), torch, bk,
        dispatch))
    merge(check_per_stage("per-stage kws hf8 pooled K=2", per_stage_launches(
        plan, [params, p2], B_MAIN, args.seed + 8, dev, torch, model_idx),
        torch, bk, dispatch))
    rplan, rparams = rgeoms[0]
    merge(check_per_stage("per-stage random geometry 0", per_stage_launches(
        rplan, [rparams], 48, args.seed + 9, dev, torch), torch, bk,
        dispatch))

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
    hop_call_ms = call_ms(lambda: mk.hop_megakernel_packed(
        *hop_args, geoms=geoms, emit=True, fc_raw=fc_raw), torch)
    for key, (ms, pms, bms, by) in timing.items():
        phase("kernels", f"time {key}: kernel {ms:.4f} ms, plain {pms:.4f} "
              f"ms, bound {bms:.6f} ms ({by}) at B={B_MAIN} hf={HOP_FRAMES}")
    phase("kernels", f"time ('hop', True) issued from Python: "
          f"{hop_call_ms:.4f} ms per call")

    # per-stage kernels at the main path's launch shapes (a hop's)
    torch.backends.cudnn.allow_tf32 = False
    fns = per_stage_fns(bk)
    per_launch = []
    for e in main_launches:
        if not e["main"]:
            continue
        kernel, plain = fns[e["name"]]
        out = kernel(*e["args"], **e["kw"])
        bms, t_b, t_o = launch_bound_ms(e, out)
        rec = dict(label=e["label"], name=e["name"],
                   ms=time_ms(lambda: kernel(*e["args"], **e["kw"]), torch),
                   call_ms=call_ms(lambda: kernel(*e["args"], **e["kw"]),
                                   torch),
                   plain_ms=time_ms(lambda: plain(*e["args"], **e["kw"]),
                                    torch, iters=5),
                   bound_ms=bms, bytes_s=t_b, ops_s=t_o, library_ms=None)
        if e["name"] != bk.TAIL_KERNEL:
            call, to_kernel_layout = library_call(e, torch)
            lib_out = to_kernel_layout(call())
            if not torch.equal(lib_out, out.float()):
                raise RuntimeError(f"conv1d disagrees with {e['label']}")
            rec["library_ms"] = time_ms(call, torch)
        per_launch.append(rec)
        phase("kernels", f"time {e['label']} ({e['name']}): kernel "
              f"{rec['ms']:.4f} ms (issued from Python "
              f"{rec['call_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
              f"bound {bms:.6f} ms, conv1d {rec['library_ms']}")
    per_kernel = {}
    for rec in per_launch:
        agg = per_kernel.setdefault(rec["name"], dict(
            ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_s=0.0,
            ops_s=0.0, library_ms=None))
        for key in ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_s",
                    "ops_s"):
            agg[key] += rec[key]
        if rec["library_ms"] is not None:
            agg["library_ms"] = (agg["library_ms"] or 0.0) + rec["library_ms"]

    # 4. launch counts
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
        phase("launches", f"megakernel emit={emit}: {n_hops} hops -> "
              f"{hops_counted}, hop-boundary peek -> "
              f"{peek_counted or 'cached logits'}")
    for emit in (True, False):
        s = StreamScheduler(spec, weights, thresholds, capacity=2,
                            hop_frames=HOP_FRAMES, backend="per_stage",
                            emit_logits=emit)
        a = s.add_stream()
        s.push_audio(a, np.random.default_rng(8).integers(
            0, 256, plan.prime_samples + 3 * plan.hop_samples,
            dtype=np.uint8))
        per_hop = []
        while True:
            with dispatch.counting() as launched:
                hb = s.step_batch()
            if hb is None:
                break
            per_hop.append(launched())
        with dispatch.counting() as launched:
            s.peek(a)
        want_hop = {bk.BITSERIAL_KERNEL: 2, bk.CONV_STEP_KERNEL: 6,
                    bk.TAIL_KERNEL: 1} if emit else {
            bk.BITSERIAL_KERNEL: 1, bk.CONV_STEP_KERNEL: 3}
        want_peek = {} if emit else {bk.BITSERIAL_KERNEL: 1,
                                     bk.CONV_STEP_KERNEL: 3,
                                     bk.TAIL_KERNEL: 1}
        n_want = 9 if emit else 4
        if (len(per_hop) != 3 or any(h != want_hop for h in per_hop)
                or s._model.dispatches_per_hop(emit) != n_want
                or launched() != want_peek
                or s._model.dispatches_per_finalize() != 5):
            raise RuntimeError(f"per-stage launch counts (emit={emit}): "
                               f"hops {per_hop}, peek {launched()}")
        phase("launches", f"per_stage emit={emit}: {len(per_hop)} hops, "
              f"{n_want} launches each {per_hop[0]}; hop-boundary peek -> "
              f"{launched() or 'cached logits'}")

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
    dispatch.reset()   # the megakernel runs' counts start here
    mega = StreamScheduler(spec, weights, thresholds, backend="megakernel",
                           **kw)
    hops, peeks, closes, hop_ms, top = drive(mega, audio, chunk_plan,
                                             plan.hop_samples, torch)
    quiet = StreamScheduler(spec, weights, thresholds, backend="megakernel",
                            emit_logits=False, **kw)
    q_hops, q_peeks, q_closes, _, _ = drive(quiet, audio, chunk_plan,
                                            plan.hop_samples, torch)
    launches = dispatch.counts()
    dispatch.reset()   # the per-stage run's counts start here
    per_stage = StreamScheduler(spec, weights, thresholds,
                                backend="per_stage", **kw)
    ps_hops, ps_peeks, ps_closes, ps_hop_ms, _ = drive(
        per_stage, audio, chunk_plan, plan.hop_samples, torch)
    ps_launches = dispatch.counts()
    dense = StreamScheduler(spec, weights, thresholds, backend="torch", **kw)
    d_hops, d_peeks, d_closes, _, _ = drive(dense, audio, chunk_plan,
                                            plan.hop_samples, torch)
    if launches.get(mk.HOP_KERNEL) != len(hops) + len(q_hops):
        raise RuntimeError(f"hop launches {launches} != hops "
                           f"{len(hops)} + {len(q_hops)}")
    if launches.get(mk.FINALIZE_KERNEL) != 1:
        raise RuntimeError(f"finalize launches {launches}: the emit-off "
                           "hop-boundary peek must launch it once")
    want_ps = {bk.BITSERIAL_KERNEL: 2 * len(ps_hops),
               bk.CONV_STEP_KERNEL: 6 * len(ps_hops),
               bk.TAIL_KERNEL: len(ps_hops)}
    if ps_launches != want_ps:
        raise RuntimeError(f"per-stage launches {ps_launches} != {want_ps} "
                           f"({len(ps_hops)} emit hops x 9)")
    if not len(hops) == len(d_hops) == len(q_hops) == len(ps_hops):
        raise RuntimeError("hop counts differ between runs")
    for (s1, f1, l1), (s2, f2, l2), (s3, f3, _), (s4, f4, l4) in zip(
            hops, d_hops, q_hops, ps_hops):
        if not all(np.array_equal(s1, x) for x in (s2, s3, s4)) or not all(
                np.array_equal(f1, x) for x in (f2, f3, f4)):
            raise RuntimeError("hop streams or frames differ between runs")
        if not np.array_equal(l1, l2):
            raise RuntimeError("megakernel hop differs from dense backend")
        if not np.array_equal(l4, l1):
            raise RuntimeError("per-stage hop differs from megakernel")
    for sid in peeks:
        if not all(np.array_equal(peeks[sid], x[sid])
                   for x in (d_peeks, q_peeks, ps_peeks)):
            raise RuntimeError(f"peek({sid}) differs between runs")
    for sid, res in closes.items():
        oracle = StreamState(plan, weights, thresholds)
        clip = audio[sid] if sid else np.concatenate([audio[0], top])
        oracle.advance(clip, flush=True)
        want = oracle.logits()
        for other in (d_closes[sid], q_closes[sid], ps_closes[sid]):
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
    ps_p50 = float(np.percentile(ps_hop_ms, 50))
    phases = {k: v["ms_p50"] for k, v in mega.metrics.phase_summary().items()}
    ps_phases = {k: v["ms_p50"]
                 for k, v in per_stage.metrics.phase_summary().items()}
    phase("main", f"{len(hops)} hops over {B_MAIN} streams (+ emit-off run "
          f"{len(q_hops)} hops), 2 peeks, {len(closes)} closes; megakernel "
          f"hop p50 {p50:.3f} ms synchronised; hop kernel "
          f"{timing[('hop', True)][0]:.4f} ms, finalize kernel "
          f"{timing['fin'][0]:.4f} ms per launch; launches {launches}; "
          f"phase p50 ms {phases}; {card}")
    phase("main", f"per_stage: {len(ps_hops)} hops, hop p50 {ps_p50:.3f} ms "
          f"synchronised; launches {ps_launches}; phase p50 ms {ps_phases}; "
          f"logits == megakernel == torch backend == StreamState; {card}")

    ms, pms, bms, by = timing[("hop", True)]
    fms, fpms, fbms, fby = timing["fin"]
    entries = [
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
    ]
    for name, replaces in ((bk.BITSERIAL_KERNEL,
                            "src/repro/kernels/bnn_conv1d.py:425"),
                           (bk.CONV_STEP_KERNEL,
                            "src/repro/kernels/bnn_conv1d.py:189"),
                           (bk.TAIL_KERNEL,
                            "src/repro/kernels/bnn_conv1d.py:315")):
        agg = per_kernel[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bnn_conv1d.cu",
            "replaces": replaces, "launches": ps_launches.get(name, 0),
            "max_abs_err": err[name], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": ("bytes" if agg["bytes_s"] >= agg["ops_s"]
                         else "operations"),
            "library_ms": agg["library_ms"]})
    kernels = {"kernels": entries}
    record = dict(kernels, card=card, hop_ms_p50=p50, hops=len(hops),
                  hop_kernel_call_ms=hop_call_ms,
                  per_stage_call_ms={k: v["call_ms"]
                                     for k, v in per_kernel.items()},
                  phase_ms_p50=phases, per_stage_hop_ms_p50=ps_p50,
                  per_stage_phase_ms_p50=ps_phases,
                  per_stage_launch_shapes=per_launch,
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
