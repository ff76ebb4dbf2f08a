"""Public entry points of the port's kernels (the reference's
``repro/kernels/ops.py``): the host side of each kernel contract.

Per-stage kernels (B.3-B.5, ``kernels/bnn_conv1d.py``):

* ``bitserial_conv1d_batched`` -- multi-bit input conv, one launch; the
  offset fold ``acc - offset * sum(w)`` stays here;
* ``bnn_conv1d_batched`` -- binary conv in ``raw`` or ``sa`` mode (SA,
  flip, OR max-pool); the window is bit-packed here;
* ``classifier_tail`` -- GAP counts through the whole fc cascade.

Each takes the reference's arguments in the reference's order and returns
its shapes and dtypes (``sa`` mode gives ``torch.uint32`` bits).  Conv
weights are ternary ``([M,] K, Cin, Cout)`` tensors, or the
:class:`ConvWeights` that :func:`conv_weights` prepares from them once
(int8 weights, packed planes, the offset fold's ``sum(w)``), which a
caller that runs every hop passes instead.  CPU tensors take each
kernel's plain version, CUDA tensors the kernel.

Hop megakernel (B.1, B.2, ``kernels/hop_megakernel.py``):
``hop_megakernel`` / ``finalize_megakernel`` take one tail and one
pending per conv stage, as the scheduler holds them, and the plan's
``ConvStage`` tuple.  They filter out the zero-width state (``tail == 0``
/ ``phase == 0``), which never enters the kernel, bring every operand to
the kernel's dtype, and put the zero-width entries back.

With a tenant pool (``model_idx``, (B,) per-slot tenant ids) every
entry point applies the reference's per-block rule: each ``bb`` slot
block computes with its first row's model.  The reference pads the batch
to a multiple of its Pallas slot block; the CUDA kernels need no padding,
so ``bb`` only scopes the tenant index.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quant
from repro_torch.kernels import bnn_conv1d as _conv
from repro_torch.kernels import hop_megakernel as _mega

#: the reference megakernel's slot block (``hop_megakernel.DEFAULT_BB``)
DEFAULT_BB = 256
#: the reference per-stage kernels' slot block (``bnn_conv1d.DEFAULT_BB``)
STEP_BB = 8


def _as(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# Packing and blocking helpers (host side of the kernel contract)
# ---------------------------------------------------------------------------

def pack_activations(x_bits) -> torch.Tensor:
    """(..., C) {0,1} -> (..., ceil(C/32)) int32 words (bit patterns of the
    reference's uint32 words)."""
    x = quant.pad_to_multiple(torch.as_tensor(x_bits), quant.PACK, -1)
    return quant.pack_bits(x, axis=-1)


def pack_weight_planes(w_t) -> tuple[torch.Tensor, torch.Tensor]:
    """Ternary (Cin, Cout) or ([M,] K, Cin, Cout) -> positive and negative
    planes packed along Cin, int32 words."""
    pos, neg = quant.ternary_planes(torch.as_tensor(w_t))
    pos = quant.pad_to_multiple(pos, quant.PACK, -2)
    neg = quant.pad_to_multiple(neg, quant.PACK, -2)
    return quant.pack_bits(pos, axis=-2), quant.pack_bits(neg, axis=-2)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pick_block(dim: int, preferred: int, step: int = 1) -> int:
    """Largest block <= preferred that is a multiple of ``step`` (the
    reference pads ``dim`` up to a block multiple)."""
    b = min(preferred, max(step, _round_up(dim, step)))
    return _round_up(b, step)


def _block_model_idx(model_idx, b: int, bb: int, pad_b: int
                     ) -> torch.Tensor:
    """(B,) per-slot tenant ids -> (B_pad // bb, 1) per-block ids: each
    block's first row's id (padding rows inherit the last block's)."""
    mi = torch.as_tensor(model_idx).to(torch.int32).reshape(-1)
    if pad_b:
        mi = torch.cat([mi, mi.new_zeros(pad_b)])
    return mi.reshape(-1, bb)[:, :1]


def _slot_model_idx(model_idx, b: int, bb: int, device) -> torch.Tensor:
    """(B,) per-slot tenant ids -> (B,) ids where every slot carries its
    block's id (the reference's per-block gather, one row per slot for
    the CUDA kernels)."""
    bb = _pick_block(b, bb)
    blocks = _block_model_idx(_as(model_idx, torch.int32, device), b, bb,
                              _round_up(b, bb) - b)
    return blocks.expand(-1, bb).reshape(-1)[:b].contiguous()


# ---------------------------------------------------------------------------
# Per-stage kernels (B.3-B.5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvWeights:
    """One conv layer's ternary weights in every form the per-stage kernels
    read, prepared once: ``w`` int8 ``([M,] K, Cin, Cout)``, ``wp``/``wn``
    packed planes ``([M,] K, Cw, Cout)`` int32, ``wsum`` int32
    ``([M,] Cout)`` (the offset fold's ``sum(w)``)."""

    w: torch.Tensor
    wp: torch.Tensor
    wn: torch.Tensor
    wsum: torch.Tensor


def conv_weights(w_t, device=None) -> ConvWeights:
    """Prepare ternary conv weights ``([M,] K, Cin, Cout)`` for the
    per-stage kernels (on ``w_t``'s device unless ``device`` is given)."""
    if isinstance(w_t, ConvWeights):
        return w_t
    w = torch.as_tensor(w_t)
    if device is not None:
        w = w.to(device)
    wp, wn = pack_weight_planes(w)
    return ConvWeights(
        w=w.to(torch.int8).contiguous(), wp=wp.contiguous(),
        wn=wn.contiguous(),
        wsum=w.to(torch.int32).sum((-3, -2), dtype=torch.int32))


def bitserial_conv1d_batched(x_u, w_t, model_idx=None, *, bits: int,
                             offset: int = 0, stride: int = 1, pad: int = 0,
                             bb: int | None = None) -> torch.Tensor:
    """Batched multi-bit-input raw conv, all bit planes in ONE launch.

    x_u (B, L, Cin) integer codes in [0, 2^bits); w_t (K, Cin, Cout)
    ternary, or a pooled (M, K, Cin, Cout) stack with ``model_idx``
    ((B,) int32 tenant ids, constant per ``bb`` slot block), or their
    :class:`ConvWeights`.  Spatial padding uses the offset code.  Returns
    (B, L_out, Cout) int32 with the offset folded out
    (``acc - offset * sum(w)``, per tenant when pooled)."""
    x = torch.as_tensor(x_u)
    device = x.device
    cw = conv_weights(w_t, device)
    b, l, cin = x.shape
    k, cin2, _ = cw.w.shape[-3:]
    if cin != cin2:
        raise ValueError(f"input has {cin} channels, weights take {cin2}")
    x = x.to(torch.int32)
    if pad:
        edge = x.new_full((b, pad, cin), offset)
        x = torch.cat([edge, x, edge], 1)
    x = x.contiguous()
    l_out = (l + 2 * pad - k) // stride + 1
    mi = None
    if model_idx is not None:
        mi = _slot_model_idx(model_idx, b, bb or STEP_BB, device)
    acc = _conv.bnn_bitserial_step(x, cw.w, mi, bits=bits, stride=stride,
                                   l_out=l_out)
    if offset:
        if mi is None:
            return acc - offset * cw.wsum[None, None, :]
        # the reference folds with each slot's own tenant row
        rows = _as(model_idx, torch.int64, device).reshape(-1)
        return acc - offset * cw.wsum.index_select(0, rows)[:, None, :]
    return acc


def bnn_conv1d_batched(x_bits, w_t, thr=None, flip=None, model_idx=None, *,
                       stride: int = 1, pad: int = 0, pool: int = 1,
                       mode: str = "sa", bb: int | None = None
                       ) -> torch.Tensor:
    """Batched binary conv1d with weights shared across the batch axis.

    x_bits (B, L, Cin) {0,1}; w_t (K, Cin, Cout) ternary (or its
    :class:`ConvWeights`).  ``sa``: (B, L_out // pool, Cout) ``uint32``
    bits (SA ``float(acc) >= thr`` xor ``flip``, then OR max-pool over
    ``pool`` consecutive positions, dropping the remainder).  ``raw``:
    (B, L_out, Cout) int32 popcount difference; with ``model_idx`` ((B,)
    tenant ids, constant per ``bb`` slot block) ``w_t`` is a pooled
    (M, K, Cin, Cout) stack (raw mode only)."""
    x = torch.as_tensor(x_bits)
    device = x.device
    cw = conv_weights(w_t, device)
    pooled = model_idx is not None
    if pooled and mode == "sa":
        raise ValueError("weight pooling is a raw-conv path feature")
    b, l, cin = x.shape
    k, cin2, _ = cw.w.shape[-3:]
    if cin != cin2:
        raise ValueError(f"input has {cin} channels, weights take {cin2}")
    l_out = (l + 2 * pad - k) // stride + 1
    xq = pack_activations(x)
    if pad:
        edge = xq.new_zeros((b, pad, xq.shape[2]))
        xq = torch.cat([edge, xq, edge], 1)
    xq = xq.contiguous()
    if mode == "sa":
        out = _conv.bnn_conv1d_step(
            xq, cw.wp, cw.wn, _as(thr, torch.float32, device),
            _as(flip, torch.int32, device), k=k, stride=stride,
            l_out=l_out, pool=pool, mode="sa")
        return out.view(torch.uint32)
    mi = _slot_model_idx(model_idx, b, bb or STEP_BB, device) \
        if pooled else None
    return _conv.bnn_conv1d_step(xq, cw.wp, cw.wn, None, None, mi, k=k,
                                 stride=stride, l_out=l_out, mode=mode)


def classifier_tail(gap, fc_ws, fc_thrs, fc_flips, model_idx=None, *,
                    out_raw, bb: int | None = None) -> torch.Tensor:
    """GAP counts -> raw logits in ONE launch: saturate at the 8-bit PWB
    ceiling, then the whole fc cascade.

    gap (B, C) int32; fc_ws per layer (Cin, Cout) ternary; fc_thrs /
    fc_flips per layer (Cout,) SA params (unused on ``out_raw`` layers).
    With ``model_idx`` ((B,) tenant ids, constant per ``bb`` slot block)
    the fc params are pooled (M, ...) stacks.  Returns (B, n_classes)
    int32."""
    gap = torch.as_tensor(gap)
    device = gap.device
    ws = tuple(_as(w, torch.int8, device) for w in fc_ws)
    thrs = tuple(None if raw else _as(t, torch.float32, device)
                 for t, raw in zip(fc_thrs, out_raw))
    flips = tuple(None if raw else _as(f, torch.int32, device)
                  for f, raw in zip(fc_flips, out_raw))
    b = gap.shape[0]
    mi = None
    if model_idx is not None:
        mi = _slot_model_idx(model_idx, b, bb or STEP_BB, device)
    return _conv.classifier_tail(_as(gap, torch.int32, device), ws, thrs,
                                 flips, mi, out_raw=tuple(out_raw))


# ---------------------------------------------------------------------------
# Hop megakernel (B.1, B.2)
# ---------------------------------------------------------------------------

def _mega_prep(stages, ws, thrs, flips, fc_ws, fc_thrs, fc_flips, device):
    geoms = tuple(_mega.stage_geom(st) for st in stages)
    i8 = lambda xs: tuple(_as(x, torch.int8, device) for x in xs)  # noqa: E731
    f32 = lambda xs: tuple(_as(x, torch.float32, device) for x in xs)  # noqa: E731,E501
    i32 = lambda xs: tuple(_as(x, torch.int32, device) for x in xs)  # noqa: E731,E501
    return (geoms, (i8(ws), f32(thrs), i32(flips), i8(fc_ws), f32(fc_thrs),
                    i32(fc_flips)))


def hop_megakernel(audio, mask, tails, pendings, gap, ws, thrs, flips,
                   fc_ws=(), fc_thrs=(), fc_flips=(), model_idx=None, *,
                   stages, emit: bool, fc_raw=(), bb: int | None = None):
    """One fused launch for a whole streaming hop.

    audio (B, hop, Cin0) codes; mask (B,) advance flags; tails/pendings
    one per conv stage; gap (B, C) counts; per-stage weights
    ``(k, cin, cout)`` ternary with ``(C,)`` thresholds/flips, and the fc
    layers' ``(cin, cout)`` weights.  With ``model_idx`` ((B,) per-slot
    tenant ids) every weight operand carries a leading pool axis.
    Returns ``(tails, pendings, gap)`` plus int32 logits when ``emit``.
    """
    device = gap.device
    geoms, params = _mega_prep(stages, ws, thrs, flips, fc_ws, fc_thrs,
                               fc_flips, device)
    b = gap.shape[0]
    nz_t = [i for i, g in enumerate(geoms) if g.tail]
    nz_p = [i for i, g in enumerate(geoms) if g.phase]
    t_in = tuple(_as(tails[i], torch.int32, device) for i in nz_t)
    p_in = tuple(_as(pendings[i], torch.int32, device) for i in nz_p)
    mi = None
    if model_idx is not None:
        mi = _slot_model_idx(model_idx, b, bb or DEFAULT_BB, device)
    out = _mega.hop_megakernel_packed(
        _as(audio, torch.int32, device), _as(mask, torch.int32, device),
        t_in, p_in, _as(gap, torch.int32, device), *params, mi,
        geoms=geoms, emit=emit, fc_raw=tuple(fc_raw))
    tails_out = list(tails)
    for j, i in enumerate(nz_t):
        tails_out[i] = out[0][j]
    pends_out = list(pendings)
    for j, i in enumerate(nz_p):
        pends_out[i] = out[1][j]
    if emit:
        return tuple(tails_out), tuple(pends_out), out[2], out[3]
    return tuple(tails_out), tuple(pends_out), out[2]


def finalize_megakernel(tails, pendings, gap, ws, thrs, flips, fc_ws,
                        fc_thrs, fc_flips, model_idx=None, *, stages,
                        fc_raw, bb: int | None = None) -> torch.Tensor:
    """Standalone ghost-flush + classifier launch (hop-boundary peeks)."""
    device = gap.device
    geoms, params = _mega_prep(stages, ws, thrs, flips, fc_ws, fc_thrs,
                               fc_flips, device)
    b = gap.shape[0]
    t_in = tuple(_as(tails[i], torch.int32, device)
                 for i, g in enumerate(geoms) if g.tail)
    p_in = tuple(_as(pendings[i], torch.int32, device)
                 for i, g in enumerate(geoms) if g.phase)
    mi = None
    if model_idx is not None:
        mi = _slot_model_idx(model_idx, b, bb or DEFAULT_BB, device)
    return _mega.finalize_megakernel_packed(
        t_in, p_in, _as(gap, torch.int32, device), *params, mi,
        geoms=geoms, fc_raw=tuple(fc_raw))
