"""The KWS cells' inputs, made from the seed: an exported model and the
streams' audio.

``random_model`` is ``chip_smoke.py``'s generator (int8 ternary weights;
float64 integer thresholds near the middle of each layer's accumulator
range, a few at +-inf as an exported a == 0 channel has; random flips),
copied here and frozen, with one change for long streams
(``gap_feed``): the conv that feeds the GAP fires on about 1 % of its
positions and the fc after the GAP compares with thresholds around 0.
The GAP counters saturate at 255; at the copied thresholds ~90 % of them
saturate within 4 s of audio and every logit goes constant, so a fault
upstream of the GAP would no longer show in what a stream emits.

The audio is a bank of ``bank_rows`` hops of uniform u8 codes.  Stream
``s`` reads row ``(j * streams + s) mod bank_rows`` as its ``j``-th hop,
so a round's chunks are one slice of the bank (no copy unless it wraps)
and every stream's audio differs; its first push is the first
``prime`` samples of row ``s`` and then its hop 1.
"""
from __future__ import annotations

import numpy as np


def random_model(layers: list[dict], seed: int, gap_feed: dict
                 ) -> tuple[dict, dict]:
    """Exported-model dicts keyed by layer index: ``(k * cin, cout)`` or
    ``(cin, cout)`` int8 ternary weights and ``(thr float64, flip bool)``.

    ``gap_feed``: ``{"input_duty": p, "z": [lo, hi], "fc_thr": a}`` draws
    the thresholds of the conv before the GAP at ``p * sum(w) + z *
    sqrt(sum|w| * p * (1 - p))`` (z uniform in [lo, hi], no flips, no
    infinities) and those of the fc after it uniform in [-a, a]."""
    rng = np.random.default_rng(seed)
    weights, thresholds = {}, {}
    gap_at = next((i for i, l in enumerate(layers) if l["type"] == "gap"),
                  None)
    feed = max((i for i, l in enumerate(layers[:gap_at])
                if l["type"] == "conv"), default=None)
    for li, lay in enumerate(layers):
        if lay["type"] == "conv":
            shape = (lay["k"] * lay["cin"], lay["cout"])
        elif lay["type"] == "fc":
            shape = (lay["cin"], lay["cout"])
        else:
            continue
        w = rng.choice(np.array([-1, 0, 1], np.int8), size=shape)
        if lay["type"] == "conv" and lay["in_bits"] > 1:
            lo, hi = (-lay["in_offset"],
                      (1 << lay["in_bits"]) - 1 - lay["in_offset"])
        elif lay["type"] == "fc" and lay["in_bits"] > 1:
            lo, hi = 0, 255          # saturated GAP counts
        else:
            lo, hi = 0, 1            # binary activations
        mid = (lo + hi) / 2 * w.sum(0)
        spread = (hi - lo) / 4 * np.sqrt(np.abs(w).sum(0) + 1)
        thr = np.round(mid + rng.uniform(-0.5, 0.5, lay["cout"]) * spread)
        inf = rng.random(lay["cout"]) < 0.02
        thr[inf] = np.where(rng.random(inf.sum()) < 0.5, -np.inf, np.inf)
        flip = rng.random(lay["cout"]) < 0.25
        if li == feed:
            p = gap_feed["input_duty"]
            z = rng.uniform(*gap_feed["z"], lay["cout"])
            sd = np.sqrt(np.abs(w).sum(0) * p * (1 - p))
            thr = np.round(p * w.sum(0) + z * sd)
            flip = np.zeros(lay["cout"], bool)
        elif gap_at is not None and li == gap_at + 1:
            a = gap_feed["fc_thr"]
            thr = np.round(rng.uniform(-a, a, lay["cout"]))
        weights[li] = w
        thresholds[li] = (thr.astype(np.float64), flip)
    return weights, thresholds


def audio_bank(seed: int, rows: int, hop: int) -> np.ndarray:
    """(rows, hop) uniform u8 codes."""
    rng = np.random.default_rng([seed, 1])
    return rng.integers(0, 256, (rows, hop), dtype=np.uint8)


def round_chunks(bank: np.ndarray, j: int, streams: int) -> np.ndarray:
    """(streams, hop): every stream's ``j``-th hop, one slice of the bank
    (two joined where it wraps)."""
    rows = bank.shape[0]
    a = (j * streams) % rows
    if a + streams <= rows:
        return bank[a:a + streams]
    return np.concatenate([bank[a:], bank[:a + streams - rows]])


def first_push(bank: np.ndarray, streams: int, prime: int) -> list:
    """Every stream's first push: ``prime`` samples of its row 0, then its
    hop 1."""
    hop1 = round_chunks(bank, 1, streams)
    head = round_chunks(bank, 0, streams)[:, :prime]
    return list(np.concatenate([head, hop1], axis=1))


def stream_audio(bank: np.ndarray, sid: int, streams: int, prime: int,
                 hops: int) -> np.ndarray:
    """Stream ``sid``'s first ``prime + hops * hop`` samples: what it has
    consumed after its ``hops``-th hop."""
    rows = bank.shape[0]
    parts = [bank[sid % rows, :prime]]
    parts += [bank[(j * streams + sid) % rows] for j in range(1, hops + 1)]
    return np.concatenate(parts)
