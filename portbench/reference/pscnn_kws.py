"""Plain reference of the PSCNN keyword-spotting CNN, from its config file.

Written from the layer list of ``configs/pscnn_kws.json`` alone; it
imports nothing of the program.  Every contraction runs in float64 on
integer values, which holds each partial sum exactly, so the reference is
exact on any device.

Semantics (the paper's digital macro):

* a multi-bit conv input is offset-binary: the layer sees ``code -
  in_offset`` and its spatial padding is the offset code (a zero after the
  shift); binary layers pad with zeros;
* a conv is a ternary contraction over (tap, channel) windows, rows laid
  out tap-major, ``(k * cin, cout)``;
* SA: ``(acc >= thr) xor flip`` -> {0, 1};
* a fused pool is an OR (max) over non-overlapping windows, the remainder
  dropped;
* GAP sums each channel over every position and saturates at 255;
* a multi-bit fc sees the counts minus its offset; the last fc is raw.

A stream's logits after a hop are the logits of the whole utterance made
of every sample the stream has consumed, as if it ended there.
"""
from __future__ import annotations

import numpy as np
import torch


def _windows(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(L, C) -> (L_out, k * C): every window of ``k`` taps, zero-padded
    ``pad`` on both sides, tap-major."""
    x = torch.nn.functional.pad(x, (0, 0, pad, pad))
    n_out = (x.shape[0] - k) // stride + 1
    win = x.unfold(0, k, stride)[:n_out]          # (L_out, C, k)
    return win.transpose(1, 2).reshape(n_out, -1)


def _sa(acc: torch.Tensor, thr, flip) -> torch.Tensor:
    thr = torch.as_tensor(np.asarray(thr, np.float64), device=acc.device)
    flip = torch.as_tensor(np.asarray(flip, bool), device=acc.device)
    return ((acc >= thr) ^ flip).to(torch.float64)


def forward(layers: list[dict], weights: dict, thresholds: dict,
            audio: np.ndarray, *, device="cpu",
            input_bits: int | None = None) -> dict:
    """The model on one utterance of u8 ``audio`` codes -> ``{"logits":
    int64 (n_classes,), "gap": int64 (channels,)}``.

    ``input_bits`` below 8 is the lower-precision control: each 8-bit
    operand (the audio codes, the GAP counts) keeps only its top
    ``input_bits`` bits."""
    def low(v: torch.Tensor) -> torch.Tensor:
        if input_bits is None:
            return v
        drop = 8 - input_bits
        return torch.div(v, 1 << drop, rounding_mode="floor") * (1 << drop)

    h = low(torch.as_tensor(np.asarray(audio, np.int64), device=device)
            .to(torch.float64))[:, None]
    gap = None
    for li, lay in enumerate(layers):
        kind = lay["type"]
        if kind == "conv":
            if lay["in_bits"] > 1:
                h = h - lay["in_offset"]
            w = torch.as_tensor(np.asarray(weights[li], np.float64),
                                device=device)
            acc = _windows(h, lay["k"], lay["stride"], lay["pad"]) @ w
            h = _sa(acc, *thresholds[li])
            p = lay["pool"]
            if p > 1:
                n = h.shape[0] // p
                h = h[:n * p].reshape(n, p, -1).amax(1)
        elif kind == "gap":
            gap = torch.clamp(h.sum(0), max=lay["saturate"])
            h = low(gap)[None, :]
        elif kind == "fc":
            w = torch.as_tensor(np.asarray(weights[li], np.float64),
                                device=device)
            acc = (h - lay["in_offset"]) @ w
            h = acc if lay["out_raw"] else _sa(acc, *thresholds[li])
        else:
            raise ValueError(f"layer {li}: unknown type {kind!r}")
    return {"logits": h[0].round().to(torch.int64).cpu().numpy(),
            "gap": gap.round().to(torch.int64).cpu().numpy()}


def posteriors(logits: np.ndarray) -> np.ndarray:
    """Softmax of the integer logits, float32, as the detector is given
    them."""
    return torch.softmax(torch.as_tensor(np.asarray(logits, np.float32)),
                         -1).numpy()
