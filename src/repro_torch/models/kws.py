"""The paper's binary keyword-spotting model (Fig. 7): its spec builders
and its offline forward through the kernel library.

The topology -- ``build_kws_spec`` (the Fig. 7 reconstruction at full
width, 64) and the reduced ``build_kws_smoke_spec`` with their constants
-- and ``offline_logits``, the whole-utterance forward through the kernel
library.  The QAT graph and ``export_kws`` stay in the reference package
until the training slice is ported; the port takes the exported numpy
``weights``/``thresholds`` dicts as they are.

  input   16,000 samples (1 s @ 16 kHz), 8-bit offset-binary
  l0   conv( 1->64,  K19, S8, pad9) bitser-8      out 2000
  b1   conv(64->128, K3,  S1, pad1) +pool2        out 1000
  b2   conv(128->256,K5,  S1, pad2) +pool2        out  500
  b3   conv(256->352,K3,  S1, pad1) +pool2        out  250
  gap  250x352 -> 8-bit counts
  fc1  352->512, bitser-8, SA binary
  fc2  512->12, raw logits
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
from repro_torch.kernels import ops

N_CLASSES = 12
IN_LEN = 16000
IN_OFFSET = 128

ROTATE_HINTS = ("b3.c1", "b3.c2", "fc1.c2", "fc1.c3")
ROWSPLIT_HINTS = {"fc2": 2}


def build_kws_spec(
    in_len: int = IN_LEN,
    width: int = 64,
    n_classes: int = N_CLASSES,
) -> CNN1DSpec:
    """The Fig. 7 reconstruction.  ``width`` scales channels (64 = paper)."""
    w = width
    return CNN1DSpec(
        in_len=in_len,
        in_channels=1,
        in_bits=8,
        name="pscnn_kws",
        layers=(
            Conv1DSpec(1, w, k=19, stride=8, pad=9, in_bits=8,
                       in_offset=IN_OFFSET, name="l0"),
            Conv1DSpec(w, 2 * w, k=3, stride=1, pad=1, pool=2, name="b1"),
            Conv1DSpec(2 * w, 4 * w, k=5, stride=1, pad=2, pool=2, name="b2"),
            Conv1DSpec(4 * w, int(5.5 * w), k=3, stride=1, pad=1, pool=2, name="b3"),
            GAPSpec(int(5.5 * w), name="gap"),
            FCSpec(int(5.5 * w), 8 * w, in_bits=8, name="fc1"),
            FCSpec(8 * w, n_classes, out_raw=True, name="fc2"),
        ),
    )


def build_kws_smoke_spec() -> CNN1DSpec:
    """Reduced config for CPU smoke tests (same family, tiny)."""
    return build_kws_spec(in_len=800, width=16)


def offline_logits(spec: CNN1DSpec, weights, thresholds, audio, *,
                   device=None) -> torch.Tensor:
    """One whole utterance through the kernel library, one launch per
    layer: what the reference's offline executor computes for the KWS
    family.

    ``audio`` (in_len,) or (in_len, in_channels) codes; ``weights`` and
    ``thresholds`` the exported model dicts (per layer index: ternary
    ``(k * cin, cout)`` weights, ``(thr, flip)``), as numpy arrays or as
    tensors already on the device.  The bit-serial first conv runs
    ``ops.bitserial_conv1d`` (B.3) and its SA here; each binary conv
    ``ops.bnn_conv1d`` with the SA and pool fused (B.6); GAP counts
    saturate at 255; the bit-serial fc sends the counts' bit planes as
    the rows of one ``ops.twm_linear`` raw call (B.7) and sums them
    weighted ``2^b`` before its SA; the last, raw fc is one
    ``ops.twm_linear`` raw call (B.7).  Returns its int32 logits
    (n_classes,).  The device follows ``ops.resolve_device``; other layer
    kinds raise."""
    device = ops.resolve_device(audio, device)
    h = torch.as_tensor(audio).to(device=device, dtype=torch.int32)
    if h.ndim == 1:
        h = h[:, None]

    def put(x, dtype):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def sa(acc, li):
        thr, flip = thresholds[li]
        return quant.apply_threshold(acc.to(torch.float32),
                                     put(thr, torch.float32),
                                     put(flip, torch.bool)).view(torch.int32)

    last = len(spec.layers) - 1
    for li, lay in enumerate(spec.layers):
        if isinstance(lay, GAPSpec):
            h = torch.clamp(h.sum(0, dtype=torch.int32), max=255)
            continue
        w = put(weights[li], torch.int32)
        bitserial = lay.in_bits > 1
        if isinstance(lay, Conv1DSpec) and not lay.out_raw and (
                not bitserial or lay.pool == 1):
            w = w.reshape(lay.k, lay.cin, lay.cout)
            geom = dict(stride=lay.stride, pad=lay.pad)
            if bitserial:
                h = sa(ops.bitserial_conv1d(h, w, lay.in_bits,
                                            lay.in_offset, **geom), li)
            else:
                thr, flip = thresholds[li]
                h = ops.bnn_conv1d(h, w, put(thr, torch.float32),
                                   put(flip, torch.int32), pool=lay.pool,
                                   mode="sa", **geom).view(torch.int32)
        elif isinstance(lay, FCSpec) and bitserial and not lay.out_raw:
            shifts = torch.arange(lay.in_bits, dtype=torch.int32,
                                  device=device)[:, None]
            planes = (h.reshape(1, -1) >> shifts) & 1
            acc = (ops.twm_linear(planes, w, mode="raw") << shifts).sum(
                0, dtype=torch.int32)
            h = sa(acc - lay.in_offset * w.sum(0, dtype=torch.int32), li)
        elif isinstance(lay, FCSpec) and lay.out_raw and li == last:
            h = ops.twm_linear(h.reshape(1, -1), w, mode="raw")[0]
        else:
            raise ValueError(f"layer {lay.name} ({lay}) is not one the KWS "
                             "family's offline path runs")
    return h
