"""The stream slot pool's hop over S shards on the card: the main path's
256 streams (the full KWS spec, ``hop_frames=8``, weights exported from a
QAT init seeded by ``--seed``) stream ragged chunks, a leave wave halfway
crowds the survivors onto shard 0 so that a rebalance fires, and the sync
megakernel scheduler runs over ``make_stream_mesh(S, device="cuda:0")``
for S = 1, 2 and 8 on one card.  Prints the hop, ``dispatch`` and
``device`` p50 (ms) and the hop kernel's launches a hop, beside the
card's name and power limit.

The code is whichever ``repro_torch`` is first on ``PYTHONPATH``, so that
two trees can be compared in one call on one card:

  PYTHONPATH=src python -m benchmarks_torch.stream_shards --tag change
  PYTHONPATH=/path/to/other/src python -m benchmarks_torch.stream_shards \\
      --tag parent

Needs a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from benchmarks_torch.common import card, row

STREAMS, HOP_FRAMES, SAMPLES = 256, 8, 32000
SHARDS = (1, 2, 8)


def model(seed: int):
    """The full KWS spec and a model exported from its QAT init."""
    from repro_torch.models import kws

    spec = kws.build_kws_spec()
    params = kws.init_kws_params(
        spec, generator=torch.Generator().manual_seed(seed), device="cpu")
    return (spec, *kws.export_kws(params, spec))


def workload(seed: int):
    """Every stream's audio and the rounds' chunk sizes (some streams
    skip a round)."""
    rng = np.random.default_rng(seed)
    audio = [rng.integers(0, 256, SAMPLES, dtype=np.uint8)
             for _ in range(STREAMS)]
    rounds, fed = [], np.zeros(STREAMS, np.int64)
    while (fed < SAMPLES).any():
        sizes = np.minimum(rng.integers(200, 2400, STREAMS), SAMPLES - fed)
        sizes[rng.random(STREAMS) < 0.15] = 0
        fed += sizes
        rounds.append(sizes)
    return audio, rounds


def drive(sched, audio, rounds) -> dict:
    """Every stream joins; each round lands through ``push_audio_batch``
    and ``drain()``; halfway every sid but those with sid % 8 == 0 below
    ``STREAMS / 2`` leaves, which crowds shard 0.  -> the metrics' p50s,
    hops and launches a hop."""
    from repro_torch.kernels import dispatch

    for sid in range(STREAMS):
        sched.add_stream(sid)
    fed = np.zeros(STREAMS, np.int64)
    live = set(range(STREAMS))
    torch.cuda.synchronize()
    dispatch.reset()
    for r, sizes in enumerate(rounds):
        if r == len(rounds) // 2:
            for sid in [s for s in range(STREAMS // 2) if s % 8]:
                sched.close_stream(sid)
                live.discard(sid)
        ids = [s for s in sorted(live) if sizes[s]]
        sched.push_audio_batch(ids, [audio[s][fed[s]:fed[s] + sizes[s]]
                                     for s in ids])
        fed[ids] += sizes[ids]
        sched.drain()
    torch.cuda.synchronize()
    m = sched.metrics
    hops = m.summary()["steps"]
    ph = m.phase_summary()
    return dict(hop=m.summary()["step_ms_p50"],
                dispatch=ph["dispatch"]["ms_p50"],
                device=ph["device"]["ms_p50"], hops=hops,
                launches=sum(dispatch.counts().values()) / max(hops, 1),
                rebalances=m.rebalances)


def run(tag: str = "", seed: int = 0) -> list[str]:
    from repro_torch.launch.mesh import make_stream_mesh
    from repro_torch.stream import StreamScheduler

    if not torch.cuda.is_available():
        raise RuntimeError("stream_shards: no card")
    spec, weights, thresholds = model(seed)
    audio, rounds = workload(seed + 5)
    where = card()
    pre = f"stream_shards{'.' + tag if tag else ''}"
    out = []
    for S in SHARDS:
        sched = StreamScheduler(
            spec, weights, thresholds, capacity=STREAMS,
            hop_frames=HOP_FRAMES, backend="megakernel",
            mesh=make_stream_mesh(S, device="cuda:0"))
        r = drive(sched, audio, rounds)
        if r["launches"] != S:
            raise RuntimeError(f"stream_shards: {r['launches']} launches a "
                               f"hop over {S} shards")
        if S > 1 and r["rebalances"] < 1:
            raise RuntimeError("stream_shards: no rebalance fired")
        for k in ("hop", "dispatch", "device"):
            out.append(row(f"{pre}.S{S}.{k}_ms_p50", f"{r[k]:.4f}",
                           f"{r['hops']} sync hops over {STREAMS} streams, "
                           f"{r['launches']:g} launches a hop; {where}"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for line in run(args.tag, args.seed):
        print(line, flush=True)


if __name__ == "__main__":
    main()
