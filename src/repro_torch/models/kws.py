"""The paper's binary keyword-spotting model (Fig. 7): its spec builders
and its offline forward through the kernel library.

The topology -- ``build_kws_spec`` (the Fig. 7 reconstruction at full
width, 64) and the reduced ``build_kws_smoke_spec`` with their constants
-- and ``offline_logits``, the whole-utterance forward through the kernel
library, with ``prepare_offline``, which lays a model out once for it.
The QAT graph and ``export_kws`` stay in the reference package until the
training slice is ported; the port takes the exported numpy
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

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class OfflineModel:
    """A KWS model laid out once for :func:`offline_logits`, on one
    device: per layer of ``spec`` the forms its kernel reads --
    :class:`~repro_torch.kernels.ops.ConvWeights` for the bit-serial conv
    (B.3) and the binary convs (B.6, with their fragment layout),
    :class:`~repro_torch.kernels.ops.LinearWeights` for the fc layers
    (B.7), and the bit-serial fc's offset fold ``in_offset * sum(w)`` --
    and each SA layer's float32 thresholds and int32 flips (None for the
    GAP and the raw fc).  :func:`prepare_offline` makes it."""

    spec: CNN1DSpec
    device: torch.device
    weights: tuple
    thresholds: tuple
    folds: tuple


def prepare_offline(spec: CNN1DSpec, weights, thresholds, *,
                    device=None) -> OfflineModel:
    """Lay out the exported model dicts (per layer index: ternary ``(k *
    cin, cout)`` weights, ``(thr, flip)``; numpy arrays or tensors) once
    for :func:`offline_logits`, on ``device`` (default: the card, by
    ``ops.resolve_device``).  Layer kinds the offline path does not run
    raise."""
    device = ops.resolve_device(None, device)
    last = len(spec.layers) - 1
    ws, sas, folds = [], [], []
    for li, lay in enumerate(spec.layers):
        fold = sa = None
        if isinstance(lay, GAPSpec):
            w = None
        else:
            w = torch.as_tensor(weights[li]).to(device, torch.int32)
            bitserial = lay.in_bits > 1
            if isinstance(lay, Conv1DSpec) and not lay.out_raw and (
                    not bitserial or lay.pool == 1):
                w = ops.conv_weights(w.reshape(lay.k, lay.cin, lay.cout),
                                     device, layout=not bitserial)
            elif isinstance(lay, FCSpec) and (
                    (bitserial and not lay.out_raw)
                    or (lay.out_raw and li == last)):
                if bitserial:
                    fold = lay.in_offset * w.sum(0, dtype=torch.int32)
                w = ops.linear_weights(w, device)
            else:
                raise ValueError(f"layer {lay.name} ({lay}) is not one the "
                                 "KWS family's offline path runs")
            if not lay.out_raw:
                thr, flip = thresholds[li]
                sa = (torch.as_tensor(thr).to(device, torch.float32),
                      torch.as_tensor(flip).to(device, torch.int32))
        ws.append(w)
        sas.append(sa)
        folds.append(fold)
    return OfflineModel(spec, device, tuple(ws), tuple(sas), tuple(folds))


def offline_logits(model, *args, device=None) -> torch.Tensor:
    """One whole utterance through the kernel library, one launch per
    layer: what the reference's offline executor computes for the KWS
    family.

    ``offline_logits(model, audio)`` with an :class:`OfflineModel` laid
    out once by :func:`prepare_offline`, which runs on its device; or
    ``offline_logits(spec, weights, thresholds, audio)`` with the exported
    model dicts (per layer index: ternary ``(k * cin, cout)`` weights,
    ``(thr, flip)``, as numpy arrays or as tensors already on the device),
    which lays the model out for this call, on the device
    ``ops.resolve_device`` gives for ``audio`` (or ``device``).  ``audio``
    is (in_len,) or (in_len, in_channels) codes.  The bit-serial first
    conv runs ``ops.bitserial_conv1d`` (B.3) and its SA here; each binary
    conv ``ops.bnn_conv1d`` with the SA and pool fused (B.6); GAP counts
    saturate at 255; the bit-serial fc sends the counts' bit planes as the
    rows of one ``ops.twm_linear`` raw call (B.7) and sums them weighted
    ``2^b`` before its SA; the last, raw fc is one ``ops.twm_linear`` raw
    call (B.7).  Returns its int32 logits (n_classes,); both forms give
    the same."""
    if isinstance(model, OfflineModel):
        (audio,) = args
        if device is not None and torch.device(device) != model.device:
            raise ValueError(f"the model lies on {model.device}, not "
                             f"{device}")
    else:
        weights, thresholds, audio = args
        model = prepare_offline(model, weights, thresholds,
                                device=ops.resolve_device(audio, device))
    device = model.device
    h = torch.as_tensor(audio).to(device=device, dtype=torch.int32)
    if h.ndim == 1:
        h = h[:, None]

    def sa(acc, li):
        thr, flip = model.thresholds[li]
        return quant.apply_threshold(acc.to(torch.float32), thr,
                                     flip).view(torch.int32)

    for li, lay in enumerate(model.spec.layers):
        w = model.weights[li]
        if isinstance(lay, GAPSpec):
            h = torch.clamp(h.sum(0, dtype=torch.int32), max=255)
        elif isinstance(lay, Conv1DSpec):
            geom = dict(stride=lay.stride, pad=lay.pad)
            if lay.in_bits > 1:
                h = sa(ops.bitserial_conv1d(h, w, lay.in_bits,
                                            lay.in_offset, **geom), li)
            else:
                h = ops.bnn_conv1d(h, w, *model.thresholds[li],
                                   pool=lay.pool, mode="sa",
                                   **geom).view(torch.int32)
        elif lay.out_raw:
            h = ops.twm_linear(h.reshape(1, -1), w, mode="raw")[0]
        else:
            shifts = torch.arange(lay.in_bits, dtype=torch.int32,
                                  device=device)[:, None]
            planes = (h.reshape(1, -1) >> shifts) & 1
            acc = (ops.twm_linear(planes, w, mode="raw") << shifts).sum(
                0, dtype=torch.int32)
            h = sa(acc - model.folds[li], li)
    return h
