"""The paper's binary keyword-spotting model (Fig. 7): its specs, its
quantization-aware training graph and export, and its offline forward
through the kernel library.

The topology -- ``build_kws_spec`` (the Fig. 7 reconstruction at full
width, 64) and the reduced ``build_kws_smoke_spec`` with their constants;
the QAT graph -- ``init_kws_params``, the batched ``kws_forward``,
``kws_loss``, ``kws_accuracy`` and the ``KWSQAT`` module -- and
``export_kws``, which folds it into ternary weights and integer SA
thresholds; ``params_from_numpy`` / ``params_to_numpy``, which carry a
parameter tree across as numpy (the port cannot draw ``jax.random``, so
the reference's params come in that way); and ``offline_logits``, the
whole-utterance forward of an exported model through the kernel library,
with ``prepare_offline``, which lays a model out once for it.

  input   16,000 samples (1 s @ 16 kHz), 8-bit offset-binary
  l0   conv( 1->64,  K19, S8, pad9) bitser-8      out 2000
  b1   conv(64->128, K3,  S1, pad1) +pool2        out 1000
  b2   conv(128->256,K5,  S1, pad2) +pool2        out  500
  b3   conv(256->352,K3,  S1, pad1) +pool2        out  250
  gap  250x352 -> 8-bit counts
  fc1  352->512, bitser-8, SA binary
  fc2  512->12, raw logits

QAT recipe (Hubara et al. [6] + TWN-style ternary weights): float32
shadow weights, ternarized forward with an identity STE; binary
activations {1, 0} with a clipped STE; a per-channel affine (a, b) before
binarization, the foldable stand-in for BN, exported as SA thresholds;
the last layer's raw popcount counts as logits, scaled by a learnable
temperature for the CE loss only (argmax-invariant).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_map

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


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_kws_params(spec: CNN1DSpec, *,
                    generator: torch.Generator | None = None,
                    device=None) -> dict:
    """QAT parameters under the reference's keys: per conv / fc layer
    ``layer{i}`` a float32 ``w`` ((K, Cin, Cout) or (Cin, Cout)), drawn
    normal with scale ``1 / sqrt(fan_in)``, and for each SA layer the
    affine ``a`` = ``1 / (sqrt(fan_in) * input_scale)`` and ``b`` = 0;
    and the CE temperature ``temp`` = 0.3.  The draws come from
    ``generator`` (default: a CPU generator seeded 0), on its own device,
    so one seed gives one model wherever it is put; the tensors go to
    ``device`` (default: the card, by ``ops.resolve_device``)."""
    device = ops.resolve_device(None, device)
    gen = generator if generator is not None else (
        torch.Generator().manual_seed(0))
    params: dict = {}
    for li, lay in enumerate(spec.layers):
        if isinstance(lay, Conv1DSpec):
            fan_in, shape = lay.k * lay.cin, (lay.k, lay.cin, lay.cout)
        elif isinstance(lay, FCSpec):
            fan_in, shape = lay.cin, (lay.cin, lay.cout)
        else:
            continue
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * (1.0 / math.sqrt(fan_in))
        entry = {"w": w.to(device)}
        if not lay.out_raw:
            # affine before the sign (the folded-BN stand-in), a > 0, scaled
            # so a * s lands inside the STE window |x| <= 1: the
            # pre-activation's std is ~sqrt(fan_in) * input_scale (~73 for
            # 8-bit offset-binary audio, ~L/8 for GAP counts, ~0.6 for
            # binary activations)
            if lay.in_bits > 1:
                input_scale = 74.0 if isinstance(lay, Conv1DSpec) else 32.0
            else:
                input_scale = 0.6
            entry["a"] = torch.full(
                (lay.cout,), 1.0 / (math.sqrt(fan_in) * input_scale),
                dtype=torch.float32, device=device)
            entry["b"] = torch.zeros(lay.cout, dtype=torch.float32,
                                     device=device)
        params[f"layer{li}"] = entry
    # CE logit scale (learnable; argmax-invariant): 0.3 puts raw-count
    # logits in a useful softmax range from step 0
    params["temp"] = torch.tensor(0.3, dtype=torch.float32, device=device)
    return params


def params_from_numpy(tree, device=None):
    """A parameter tree of numpy arrays (the reference's params, through
    ``np.asarray``) as tensors of the same dtypes on ``device`` (default:
    the card, by ``ops.resolve_device``)."""
    device = ops.resolve_device(None, device)
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(device),
                    tree)


def params_to_numpy(params):
    """A parameter tree of tensors as numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


# ---------------------------------------------------------------------------
# QAT forward (batched)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _exact_float32():
    """Float32 matmuls at full precision (no TF32) inside the block, the
    setting restored after.  The QAT pre-activations are integer sums
    below 2^24 (|s| <= 2413 at l0, 1280 at b2, 88,000 at fc1 at full
    width), exact in float32 in any order, and the export's integer
    thresholds rely on that exactness; TF32 would round them."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _conv1d(h: torch.Tensor, w: torch.Tensor, stride: int, pad: int
            ) -> torch.Tensor:
    """(B, L, Cin) x (K, Cin, Cout) -> (B, L_out, Cout) as an unfold and
    one float32 matmul: exact integer math, no algorithm choice."""
    k, cin, cout = w.shape
    win = F.pad(h, (0, 0, pad, pad)).unfold(1, k, stride)  # (B, Lo, Cin, K)
    cols = win.transpose(2, 3).reshape(h.shape[0], win.shape[1], k * cin)
    return cols @ w.reshape(k * cin, cout)


def _maxpool(h: torch.Tensor, p: int) -> torch.Tensor:
    """Max over windows of ``p`` positions of (B, L, C).  ``amax`` splits
    the gradient evenly among tied maxima, as the reference's ``jnp.max``
    does (``max_pool1d`` would send it to one of them); with {0, 1}
    activations most windows tie."""
    b, length, c = h.shape
    n = (length // p) * p
    return h[:, :n].reshape(b, n // p, p, c).amax(2)


def kws_forward(params: dict, x_u8: torch.Tensor, spec: CNN1DSpec,
                preacts: list | None = None) -> torch.Tensor:
    """x_u8: (B, L) uint8 offset-binary audio -> (B, n_classes) float32
    raw-count logits: the reference's per-example forward over a batch.
    ``preacts``, when a list, receives each conv / fc layer's
    pre-activation ``s`` (integer-valued float32)."""
    h = (x_u8.to(torch.float32) - IN_OFFSET)[:, :, None]  # (B, L, 1)
    with _exact_float32():
        for li, lay in enumerate(spec.layers):
            p = params.get(f"layer{li}")
            if isinstance(lay, Conv1DSpec):
                s = _conv1d(h, quant.ternarize_weight(p["w"]), lay.stride,
                            lay.pad)
                h = quant.binarize_act(p["a"] * s + p["b"])
                if lay.pool > 1:
                    h = _maxpool(h, lay.pool)
            elif isinstance(lay, GAPSpec):
                # counts per example (the PWB counters).  The QAT GAP does
                # not saturate where the deployed one clamps at 255; the
                # counts stay <= 250 at full width (<= 12 on the smoke
                # spec), so both give the same answer
                h = h.sum(1)
                continue
            elif isinstance(lay, FCSpec):
                s = h.reshape(h.shape[0], -1) @ quant.ternarize_weight(
                    p["w"])
                h = s if lay.out_raw else quant.binarize_act(
                    p["a"] * s + p["b"])
            if preacts is not None:
                preacts.append(s)
    return h


def kws_loss(params: dict, batch_x: torch.Tensor, batch_y: torch.Tensor,
             spec: CNN1DSpec) -> torch.Tensor:
    """Mean cross-entropy of the temperature-scaled logits."""
    logits = kws_forward(params, batch_x, spec) * params["temp"]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, batch_y.long()[:, None]).mean()


def kws_accuracy(params: dict, batch_x: torch.Tensor, batch_y: torch.Tensor,
                 spec: CNN1DSpec) -> torch.Tensor:
    """Share of the batch whose logits' argmax is the label (float32)."""
    logits = kws_forward(params, batch_x, spec)
    return (logits.argmax(-1) == batch_y.long()).to(torch.float32).mean()


class KWSQAT(torch.nn.Module):
    """The QAT model as a module: ``layers[f"layer{i}"]`` holds the
    layer's ``w`` / ``a`` / ``b`` and ``temp`` the CE temperature, the
    reference's keys; :meth:`forward` is :func:`kws_forward`."""

    def __init__(self, spec: CNN1DSpec, params: dict) -> None:
        super().__init__()
        self.spec = spec
        self.layers = torch.nn.ModuleDict({
            key: torch.nn.ParameterDict(
                {k: torch.nn.Parameter(v) for k, v in entry.items()})
            for key, entry in params.items() if key != "temp"})
        self.temp = torch.nn.Parameter(params["temp"])

    def param_tree(self) -> dict:
        """The parameters as the functional API's tree."""
        tree = {key: dict(entry.items()) for key, entry in self.layers.items()}
        tree["temp"] = self.temp
        return tree

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        return kws_forward(self.param_tree(), x_u8, self.spec)


# ---------------------------------------------------------------------------
# Export: QAT params -> (ternary weights, SA thresholds) for the deploy
# ---------------------------------------------------------------------------

def export_kws(params: dict, spec: CNN1DSpec) -> tuple[dict, dict]:
    """Fold the affines into *integer* SA thresholds: numpy int8 ternary
    weights (the QAT shapes) and per SA layer (float64 thresholds, bool
    flips).

    Pre-activations s are integers, so ``a*s+b >= 0`` is exactly ``s >=
    ceil(-b/a)`` (a > 0), ``s <= floor(-b/a)`` (a < 0: the threshold
    ``floor(-b/a) + 1`` with the flip), and a constant where a == 0
    (``-inf`` when b >= 0, else ``+inf``).  The raw layer gets zero
    thresholds and no flips."""
    weights: dict[int, np.ndarray] = {}
    thresholds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for li, lay in enumerate(spec.layers):
        p = params.get(f"layer{li}")
        if p is None:
            continue
        with torch.no_grad():
            w_t = quant.ternarize_weight(p["w"])
        weights[li] = w_t.cpu().numpy().astype(np.int8)
        if "a" in p:
            a = p["a"].detach().cpu().numpy().astype(np.float64)
            b = p["b"].detach().cpu().numpy().astype(np.float64)
            t = -b / np.where(a == 0, 1.0, a)
            thr = np.where(a > 0, np.ceil(t), np.floor(t) + 1)
            thr = np.where(a == 0, np.where(b >= 0, -np.inf, np.inf), thr)
            thresholds[li] = (thr.astype(np.float64), a < 0)
        else:
            thresholds[li] = (np.zeros(lay.cout, np.float64),
                              np.zeros(lay.cout, bool))
    return weights, thresholds


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
