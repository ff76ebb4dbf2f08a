"""Public entry points of the port's kernels (the reference's
``repro/kernels/ops.py``, hop megakernel part).

``hop_megakernel`` / ``finalize_megakernel`` take one tail and one pending
per conv stage, as the scheduler holds them, and the plan's ``ConvStage``
tuple.  They filter out the zero-width state (``tail == 0`` /
``phase == 0``), which never enters the kernel, bring every operand to the
kernel's dtype, turn a per-slot tenant index into the per-block one of the
reference (each ``bb`` slot block computes with its first row's model),
call the packed entry point once, and put the zero-width entries back.

The reference pads the batch to a multiple of its Pallas slot block; the
CUDA kernel runs one CTA per slot, so any batch size launches as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import hop_megakernel as _mega

#: slot block of the reference kernel; here it only scopes a tenant index
DEFAULT_BB = 256


def _as(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()


def _mega_prep(stages, ws, thrs, flips, fc_ws, fc_thrs, fc_flips, device):
    geoms = tuple(_mega.stage_geom(st) for st in stages)
    i8 = lambda xs: tuple(_as(x, torch.int8, device) for x in xs)  # noqa: E731
    f32 = lambda xs: tuple(_as(x, torch.float32, device) for x in xs)  # noqa: E731,E501
    i32 = lambda xs: tuple(_as(x, torch.int32, device) for x in xs)  # noqa: E731,E501
    return (geoms, (i8(ws), f32(thrs), i32(flips), i8(fc_ws), f32(fc_thrs),
                    i32(fc_flips)))


def _slot_model_idx(model_idx, b: int, bb: int, device) -> torch.Tensor:
    """(B,) per-slot tenant ids -> (B,) ids where every ``bb`` slot block
    carries its first row's id (the reference's per-block gather)."""
    mi = _as(model_idx, torch.int32, device).reshape(-1)
    first = (torch.arange(b, device=device) // bb) * bb
    return mi.index_select(0, first).contiguous()


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
