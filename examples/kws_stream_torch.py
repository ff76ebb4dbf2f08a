"""Always-on streaming KWS on the PyTorch port: many live audio streams,
one shared model.

1. build + briefly QAT-train the reduced binary KWS CNN,
2. export ternary weights + SA thresholds (the artifacts the compiler
   eats),
3. open a ``StreamScheduler`` (the megakernel backend: one hop kernel
   launch a hop on the card, its plain version on the CPU) and let
   several synthetic "microphones" push audio in ragged chunks through
   the vectorized ingest plane (``push_audio_batch``; the elastic slot
   pool grows from its minimum as they join),
4. watch the per-hop finalized logits feed the hysteresis detector and
   emit keyword events per stream,
5. close each stream and check that the flushed logits equal the chip
   twin's executor on the same audio, bit for bit.

Run:  PYTHONPATH=src python examples/kws_stream_torch.py
          [--steps N] [--device cuda|cpu]
(the default device is the card.)  Exits non-zero on a streaming /
offline divergence.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import compiler
from repro_torch.core.executor import Executor
from repro_torch.data import gscd
from repro_torch.kernels import ops
from repro_torch.models import kws
from repro_torch.stream import DetectorConfig, StreamScheduler
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_lib

BATCH, IN_LEN, WIDTH = 24, 2000, 16
N_STREAMS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(None, args.device)

    spec = kws.build_kws_spec(in_len=IN_LEN, width=WIDTH)
    params = kws.init_kws_params(spec, device=dev)
    ocfg = opt_lib.OptConfig(lr=2e-3)
    state = opt_lib.init_opt_state(ocfg, params)

    def loss_fn(p, batch):
        return kws.kws_loss(p, *batch, spec)

    print(f"training briefly on the synthetic corpus ({dev})...")
    loss = float("nan")
    for i in range(args.steps):
        xb, yb = gscd.batch(seed=0, step=i, batch_size=BATCH, n=IN_LEN)
        loss, grads = loop.value_and_grad(
            loss_fn, params, (torch.as_tensor(xb).to(dev),
                              torch.as_tensor(yb).to(dev)))
        state, _ = opt_lib.update(ocfg, state, grads)
        params = opt_lib.cast_params_like(state["master"], params)
    print(f"  final loss {float(loss):.3f}")

    weights, thresholds = kws.export_kws(params, spec)
    sched = StreamScheduler(
        spec, weights, thresholds, capacity=N_STREAMS, hop_frames=2,
        detector_cfg=DetectorConfig(smooth_frames=2, on_threshold=0.5),
        device=dev,
    )
    plan = sched.plan
    print(f"\nstream plan: hop={plan.hop_samples} samples "
          f"({plan.frames_per_hop} frames), prime={plan.prime_samples}, "
          f"tails={[st.tail for st in plan.convs]}")

    # each stream speaks one keyword; chunks arrive ragged like RTP packets
    rng = np.random.default_rng(3)
    classes = rng.integers(0, 10, N_STREAMS)
    clips = [gscd.sample(rng, int(c), n=IN_LEN) for c in classes]
    sids = [sched.add_stream() for _ in range(N_STREAMS)]
    pos = [0] * N_STREAMS
    while any(p < IN_LEN for p in pos):
        feed_sids, feed_chunks = [], []
        for j, sid in enumerate(sids):
            n = int(rng.integers(80, 400))
            if pos[j] < IN_LEN:
                feed_sids.append(sid)
                feed_chunks.append(clips[j][pos[j]:pos[j] + n])
                pos[j] += n
        # one vectorized quantize+scatter lands every microphone's chunk
        sched.push_audio_batch(feed_sids, feed_chunks)
        for sid, _, _, det in sched.step():
            if det is not None:
                print(f"  [stream {sid}] DETECT class {det.cls} "
                      f"@frame {det.frame} score {det.score:.2f}")
    sched.run_until_starved()

    print("\nclosing streams (flush) and checking offline bit-exactness:")
    prog = compiler.compile_model(spec, weights, thresholds, device=dev)
    ex = Executor(prog)
    mismatches = 0
    for j, sid in enumerate(sids):
        res = sched.close_stream(sid)
        off = np.asarray(ex.run(clips[j][:, None]).output.cpu()).ravel()
        ok = np.array_equal(np.asarray(res.logits), off)
        mismatches += not ok
        pred = int(np.argmax(res.logits))
        print(f"  stream {sid}: true={classes[j]} pred={pred} "
              f"frames={res.frames} events={len(res.events)} "
              f"offline-match={'OK' if ok else 'MISMATCH'}")

    m = sched.metrics.summary()
    e = sched.metrics.energy_summary()
    print(f"\nmetrics: {m['frames_total']:.0f} frames, "
          f"{m['frames_per_sec']:.0f} frames/s, "
          f"step p50 {m['step_ms_p50']:.1f} ms (hop -> logits; host pack "
          f"{m['host_pack_ms_p50']:.2f} ms of it), simulated-silicon "
          f"equivalent {e['tops_per_w_equiv']:.0f} TOPS/W")
    print(f"elastic pool: {m['resizes']:.0f} resizes, "
          f"final capacity {sched.capacity} of max {sched.max_capacity}")
    if mismatches:
        raise SystemExit("streaming/offline divergence")
    return N_STREAMS


if __name__ == "__main__":
    main()
