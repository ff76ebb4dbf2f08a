"""Public entry points of the port's kernels (the reference's
``repro/kernels/ops.py``): the host side of each kernel contract.

Kernel library (single stream, ``kernels/twm_matmul.py`` and
``kernels/conv_kernels.py``), one launch per call:

* ``twm_linear`` -- dense layer on the packed popcount GEMM (B.7), raw or
  ``sa``; ``twm_linear_mxu`` -- the same ``sa`` layer on the int8 tensor
  cores (B.8); ``pick_path`` chooses between them from the shape;
* ``bnn_conv1d`` -- fused conv -> SA -> OR-pool, the paper's PWB write-back
  (B.6), or its raw conv;
* ``bitserial_conv1d`` -- multi-bit input conv, the single-stream form of
  ``bitserial_conv1d_batched`` (B.3).

Per-stage kernels (B.3-B.5, ``kernels/conv_kernels.py``):

* ``bitserial_conv1d_batched`` -- multi-bit input conv, one launch; the
  offset fold ``acc - offset * sum(w)`` stays here;
* ``bnn_conv1d_batched`` -- binary conv in ``raw`` or ``sa`` mode (SA,
  flip, OR max-pool); the window is bit-packed here;
* ``classifier_tail`` -- GAP counts through the whole fc cascade.

Each takes the reference's arguments in the reference's order and returns
its shapes and dtypes (``sa`` mode gives ``torch.uint32`` bits).  Conv
weights are ternary ``([M,] K, Cin, Cout)`` tensors, or the
:class:`ConvWeights` that :func:`conv_weights` prepares from them once
(int8 weights, packed planes, their tensor-core layout, the offset fold's
``sum(w)``), which a caller that runs every hop or utterance passes
instead; ``twm_linear`` takes dense weights or their
:class:`LinearWeights` (packed planes) alike.

Device rule, the same for every entry point: a ``torch.Tensor`` input
keeps its device -- a CPU tensor is how a caller asks for the kernels'
plain versions, a CUDA tensor launches the kernel -- and any other input
(a numpy array, a list) goes to the card.  A ``device=`` keyword
overrides both.  A call bound for the card raises when there is none; it
never falls back to the CPU.

Hop megakernel (B.1, B.2, ``kernels/hop_megakernel.py``):
``hop_megakernel`` / ``finalize_megakernel`` take one tail and one
pending per conv stage, as the scheduler holds them, and the plan's
``ConvStage`` tuple.  They filter out the zero-width state (``tail == 0``
/ ``phase == 0``), which never enters the kernel, bring every operand to
the kernel's dtype, and put the zero-width entries back.

A slot pool over the S shards of a ``launch.mesh.make_stream_mesh``
mesh calls these entry points once per shard, on the shard's rows and
the weights on its device (``stream.scheduler._ShardedModel``, the port
of the reference's ``*_sharded`` ``shard_map`` wrappers);
``remap_slot_rows`` is the device half of a cross-shard migration.

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
from repro_torch.kernels import conv_kernels as _conv
from repro_torch.kernels import hop_megakernel as _mega
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import twm_matmul as _mm
from repro_torch.runtime.remap import remap_device_rows

#: the reference megakernel's slot block (``hop_megakernel.DEFAULT_BB``)
DEFAULT_BB = 256
#: the reference per-stage kernels' slot block (``bnn_conv1d.DEFAULT_BB``)
STEP_BB = 8


def resolve_device(x, device=None) -> torch.device:
    """Where an entry point runs: ``device`` when given, else the device
    of ``x`` when it is a tensor, else the card.  Raises when that is a
    CUDA device and there is none."""
    if device is not None:
        dev = torch.device(device)
    elif isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port's kernels run on a CUDA device and none is "
            "available; pass CPU tensors or device='cpu' to run their "
            "plain versions")
    return dev


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


def shifted_strided_views(x_packed, k: int, stride: int, pad: int
                          ) -> torch.Tensor:
    """(L, Cw) packed -> (K, L_out, Cw) tap views, ``out[t, p] =
    x_pad[p * stride + t]`` (the line-buffer mirror).  The reference's conv
    kernel reads these views; B.6 indexes the taps of the (L, Cw) input
    itself, so the library path does not build them."""
    return _ref._shifted_views(x_packed, k, stride, pad)


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
    """One conv layer's ternary weights in every form the conv kernels
    read, prepared once: ``w`` int8 ``([M,] K, Cin, Cout)``, ``wp``/``wn``
    packed planes ``([M,] K, Cw, Cout)`` int32, ``wf`` the planes laid out
    for the 1-bit tensor-core GEMM of B.4 and B.6
    (``conv_kernels.prepare_step_weights``; None when made for B.3 only),
    ``wsum`` int32 ``([M,] Cout)`` (the offset fold's ``sum(w)``)."""

    w: torch.Tensor
    wp: torch.Tensor
    wn: torch.Tensor
    wf: torch.Tensor | None
    wsum: torch.Tensor


def conv_weights(w_t, device=None, *, layout: bool = True) -> ConvWeights:
    """Prepare ternary conv weights ``([M,] K, Cin, Cout)`` for the conv
    kernels (on the device the module's rule gives).  ``layout=False``
    skips the layout of B.4 and B.6, which the B.3 entry points never
    read."""
    if isinstance(w_t, ConvWeights):
        return w_t
    w = torch.as_tensor(w_t).to(resolve_device(w_t, device))
    wp, wn = pack_weight_planes(w)
    wp, wn = wp.contiguous(), wn.contiguous()
    return ConvWeights(
        w=w.to(torch.int8).contiguous(), wp=wp, wn=wn,
        wf=_conv.prepare_step_weights(wp, wn) if layout else None,
        wsum=w.to(torch.int32).sum((-3, -2), dtype=torch.int32))


def bitserial_conv1d_batched(x_u, w_t, model_idx=None, *, bits: int,
                             offset: int = 0, stride: int = 1, pad: int = 0,
                             bb: int | None = None, device=None
                             ) -> torch.Tensor:
    """Batched multi-bit-input raw conv, all bit planes in ONE launch.

    x_u (B, L, Cin) integer codes in [0, 2^bits); w_t (K, Cin, Cout)
    ternary, or a pooled (M, K, Cin, Cout) stack with ``model_idx``
    ((B,) int32 tenant ids, constant per ``bb`` slot block), or their
    :class:`ConvWeights`.  Spatial padding uses the offset code.  Returns
    (B, L_out, Cout) int32 with the offset folded out
    (``acc - offset * sum(w)``, per tenant when pooled)."""
    device = resolve_device(x_u, device)
    x = torch.as_tensor(x_u).to(device)
    cw = conv_weights(w_t, device, layout=False)
    b, l, cin = x.shape
    k, cin2, _ = cw.w.shape[-3:]
    if cin != cin2:
        raise ValueError(f"input has {cin} channels, weights take {cin2}")
    x = x.to(torch.int32)
    if pad:
        edge = x.new_full((b, pad, cin), offset)
        x = torch.cat([edge, x, edge], 1)
    x = x.contiguous()
    l_out = _ref.conv1d_out_len(l, k, stride, pad)
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
                       mode: str = "sa", bb: int | None = None,
                       device=None) -> torch.Tensor:
    """Batched binary conv1d with weights shared across the batch axis.

    x_bits (B, L, Cin) {0,1}; w_t (K, Cin, Cout) ternary (or its
    :class:`ConvWeights`).  ``sa``: (B, L_out // pool, Cout) ``uint32``
    bits (SA ``float(acc) >= thr`` xor ``flip``, then OR max-pool over
    ``pool`` consecutive positions, dropping the remainder).  ``raw``:
    (B, L_out, Cout) int32 popcount difference; with ``model_idx`` ((B,)
    tenant ids, constant per ``bb`` slot block) ``w_t`` is a pooled
    (M, K, Cin, Cout) stack (raw mode only)."""
    device = resolve_device(x_bits, device)
    x = _as(x_bits, torch.int32, device)
    cw = conv_weights(w_t, device)
    pooled = model_idx is not None
    if pooled and mode == "sa":
        raise ValueError("weight pooling is a raw-conv path feature")
    b, l, cin = x.shape
    k, cin2, _ = cw.w.shape[-3:]
    if cin != cin2:
        raise ValueError(f"input has {cin} channels, weights take {cin2}")
    l_out = _ref.conv1d_out_len(l, k, stride, pad)
    xq = pack_activations(x)
    if pad:
        edge = xq.new_zeros((b, pad, xq.shape[2]))
        xq = torch.cat([edge, xq, edge], 1)
    xq = xq.contiguous()
    if mode == "sa":
        out = _conv.bnn_conv1d_step(
            xq, cw.wp, cw.wn, _as(thr, torch.float32, device),
            _as(flip, torch.int32, device), k=k, stride=stride,
            l_out=l_out, pool=pool, mode="sa", wf=cw.wf)
        return out.view(torch.uint32)
    mi = _slot_model_idx(model_idx, b, bb or STEP_BB, device) \
        if pooled else None
    return _conv.bnn_conv1d_step(xq, cw.wp, cw.wn, None, None, mi, k=k,
                                 stride=stride, l_out=l_out, mode=mode,
                                 wf=cw.wf)


def classifier_tail(gap, fc_ws, fc_thrs, fc_flips, model_idx=None, *,
                    out_raw, bb: int | None = None, device=None
                    ) -> torch.Tensor:
    """GAP counts -> raw logits in ONE launch: saturate at the 8-bit PWB
    ceiling, then the whole fc cascade.

    gap (B, C) int32 counts (>= 0); fc_ws per layer (Cin, Cout) ternary,
    or the :class:`~repro_torch.kernels.conv_kernels.TailWeights` that
    ``conv_kernels.prepare_tail_weights`` lays out once from int8 ones on
    this device; fc_thrs / fc_flips per layer (Cout,) SA params (unused on
    ``out_raw`` layers).  With ``model_idx`` ((B,) tenant ids, constant
    per ``bb`` slot block) the fc params are pooled (M, ...) stacks.
    Returns (B, n_classes) int32."""
    device = resolve_device(gap, device)
    gap = torch.as_tensor(gap)
    ws = fc_ws if isinstance(fc_ws, _conv.TailWeights) else tuple(
        _as(w, torch.int8, device) for w in fc_ws)
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
    if not isinstance(ws, _mega.HopWeights):
        ws, fc_ws = i8(ws), i8(fc_ws)
    return (geoms, (ws, f32(thrs), i32(flips), fc_ws, f32(fc_thrs),
                    i32(fc_flips)))


def hop_megakernel(audio, mask, tails, pendings, gap, ws, thrs, flips,
                   fc_ws=(), fc_thrs=(), fc_flips=(), model_idx=None, *,
                   stages, emit: bool, fc_raw=(), bb: int | None = None,
                   device=None, out=None):
    """One fused launch for a whole streaming hop.

    audio (B, hop, Cin0) codes; mask (B,) advance flags; tails/pendings
    one per conv stage; gap (B, C) counts; per-stage weights
    ``(k, cin, cout)`` ternary (or a ``HopWeights`` laid out once by
    ``hop_megakernel.prepare_hop_weights``, which carries the fc weights
    too) with ``(C,)`` thresholds/flips, and the fc layers' ``(cin,
    cout)`` weights.  With ``model_idx`` ((B,) per-slot
    tenant ids) every weight operand carries a leading pool axis.
    Returns ``(tails, pendings, gap)`` plus int32 logits when ``emit``.
    ``out`` (a ``(tails, pendings, gap)`` like the inputs, int32 on the
    device, sharing no memory with them; with ``emit`` it may also hold a
    ``(B, n_classes)`` int32 logits tensor) receives the new state (and
    logits) instead of fresh tensors.
    """
    device = resolve_device(gap, device)
    geoms, params = _mega_prep(stages, ws, thrs, flips, fc_ws, fc_thrs,
                               fc_flips, device)
    return _hop(geoms, params, device, audio, mask, tails, pendings, gap,
                model_idx, emit=emit, fc_raw=fc_raw, bb=bb, out=out)


def _hop(geoms, params, device, audio, mask, tails, pendings, gap,
         model_idx, *, emit, fc_raw, bb, out):
    """:func:`hop_megakernel` on prepared weights (``_mega_prep``)."""
    b = gap.shape[0]
    nz_t = [i for i, g in enumerate(geoms) if g.tail]
    nz_p = [i for i, g in enumerate(geoms) if g.phase]
    t_in = tuple(_as(tails[i], torch.int32, device) for i in nz_t)
    p_in = tuple(_as(pendings[i], torch.int32, device) for i in nz_p)
    mi = None
    if model_idx is not None:
        mi = _slot_model_idx(model_idx, b, bb or DEFAULT_BB, device)
    if out is not None:
        out = (tuple(out[0][i] for i in nz_t),
               tuple(out[1][i] for i in nz_p), *out[2:])
    out = _mega.hop_megakernel_packed(
        _as(audio, torch.int32, device), _as(mask, torch.int32, device),
        t_in, p_in, _as(gap, torch.int32, device), *params, mi,
        geoms=geoms, emit=emit, fc_raw=tuple(fc_raw), out=out)
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
                        fc_raw, bb: int | None = None, device=None
                        ) -> torch.Tensor:
    """Standalone ghost-flush + classifier launch (hop-boundary peeks)."""
    device = resolve_device(gap, device)
    geoms, params = _mega_prep(stages, ws, thrs, flips, fc_ws, fc_thrs,
                               fc_flips, device)
    return _finalize(geoms, params, device, tails, pendings, gap,
                     model_idx, fc_raw=fc_raw, bb=bb)


def _finalize(geoms, params, device, tails, pendings, gap, model_idx, *,
              fc_raw, bb) -> torch.Tensor:
    """:func:`finalize_megakernel` on prepared weights (``_mega_prep``)."""
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


def remap_slot_rows(x, perm, keep):
    """Permute the slot rows of one batched state tensor: ``out[i] =
    x[perm[i]]`` where ``keep[i]``, else a zero row.  The device half of a
    cross-shard migration (``SlotPlacement.rebalance``), a name for
    ``runtime.remap.remap_device_rows``: over the shards of a mesh
    (a :class:`~repro_torch.launch.mesh.ShardRows`) each destination
    shard's rows are gathered from their source shards and built on the
    destination's device."""
    return remap_device_rows(x, perm, keep)


# ---------------------------------------------------------------------------
# Kernel library, single stream (B.6-B.8, B.3)
# ---------------------------------------------------------------------------

def _sa_operands(thr, flip, device):
    if thr is None or flip is None:
        raise ValueError("sa mode needs thr and flip")
    return _as(thr, torch.float32, device), _as(flip, torch.int32, device)


@dataclasses.dataclass(frozen=True)
class LinearWeights:
    """A dense layer's ternary ``(K, N)`` weights as B.7 reads them,
    prepared once: ``wp``/``wn`` the positive and negative planes packed
    along K, ``(ceil(K / 32), N)`` int32."""

    wp: torch.Tensor
    wn: torch.Tensor


def linear_weights(w_t, device=None) -> LinearWeights:
    """Pack ternary dense weights ``(K, N)`` for B.7 (on the device the
    module's rule gives)."""
    if isinstance(w_t, LinearWeights):
        return w_t
    wp, wn = pack_weight_planes(_as(w_t, torch.int32,
                                    resolve_device(w_t, device)))
    return LinearWeights(wp.contiguous(), wn.contiguous())


def twm_linear(x_bits, w_t, thr=None, flip=None, *, mode: str = "sa",
               device=None) -> torch.Tensor:
    """Binary-activation ternary-weight dense layer on the packed popcount
    GEMM (B.7), ONE launch.

    x_bits (M, K) {0,1}; w_t (K, N) {-1,0,1}, or its
    :class:`LinearWeights` (packed once).  Returns (M, N):
    ``torch.uint32`` bits in ``sa`` mode, int32 popcount difference in
    ``raw`` mode.  The kernel masks the ragged tile edges itself, so
    nothing is padded beyond the 32-lane word."""
    device = resolve_device(x_bits, device)
    xq = pack_activations(_as(x_bits, torch.int32, device)).contiguous()
    lw = linear_weights(w_t, device)
    if mode == "sa":
        out = _mm.twm_matmul(xq, lw.wp, lw.wn,
                             *_sa_operands(thr, flip, device), mode="sa")
        return out.view(torch.uint32)
    return _mm.twm_matmul(xq, lw.wp, lw.wn, mode=mode)


def twm_linear_mxu(x_bits, w_t, thr, flip, *, device=None) -> torch.Tensor:
    """The same ``sa`` dense layer on the int8 tensor cores (B.8), ONE
    launch: x_bits (M, K) {0,1}, w_t (K, N) {-1,0,1} -> (M, N)
    ``torch.uint32`` bits.  K is zero-padded to the MMA's 32 (inactive
    wordlines) and the weights go K-contiguous, as the MMA reads them."""
    device = resolve_device(x_bits, device)
    x8 = quant.pad_to_multiple(_as(x_bits, torch.int8, device), _mm.MXU_K,
                               1).contiguous()
    wt8 = quant.pad_to_multiple(_as(w_t, torch.int8, device).t(),
                                _mm.MXU_K, 1).contiguous()
    out = _mm.twm_matmul_mxu(x8, wt8, *_sa_operands(thr, flip, device))
    return out.view(torch.uint32)


def bnn_conv1d(x_bits, w_t, thr=None, flip=None, *, stride: int = 1,
               pad: int = 0, pool: int = 1, mode: str = "sa", device=None
               ) -> torch.Tensor:
    """Fused binary conv1d -> SA -> max-pool, the paper's conv + PWB
    pipeline (B.6), ONE launch.

    x_bits (L, Cin) {0,1}; w_t (K, Cin, Cout) ternary (or its
    :class:`ConvWeights`, which a caller that runs every utterance
    prepares once).  Output (L_out // pool, Cout) ``torch.uint32`` bits,
    or (L_out, Cout) int32 when ``mode='raw'`` (which ignores ``pool``, as
    the reference does)."""
    device = resolve_device(x_bits, device)
    x = _as(x_bits, torch.int32, device)
    cw = conv_weights(w_t, device)
    k, cin, _ = cw.w.shape
    if x.shape[1] != cin:
        raise ValueError(f"input has {x.shape[1]} channels, weights take "
                         f"{cin}")
    l_out = _ref.conv1d_out_len(x.shape[0], k, stride, pad)
    xq = pack_activations(x).contiguous()
    geom = dict(k=k, stride=stride, pad=pad, l_out=l_out, wf=cw.wf)
    if mode == "sa":
        out = _conv.bnn_conv1d(xq, cw.wp, cw.wn,
                               *_sa_operands(thr, flip, device), pool=pool,
                               mode="sa", **geom)
        return out.view(torch.uint32)
    return _conv.bnn_conv1d(xq, cw.wp, cw.wn, pool=1, mode=mode, **geom)


def bitserial_conv1d(x_u, w_t, bits: int, offset: int = 0, *,
                     stride: int = 1, pad: int = 0, device=None
                     ) -> torch.Tensor:
    """Multi-bit-input conv in ONE launch (B.3), the first-layer path:
    x_u (L, Cin) codes < 2^bits, w_t (K, Cin, Cout) ternary -> (L_out,
    Cout) int32 with the offset folded out.  Spatial padding uses the
    offset code."""
    device = resolve_device(x_u, device)
    x = torch.as_tensor(x_u).to(device)
    return bitserial_conv1d_batched(x[None], w_t, bits=bits, offset=offset,
                                    stride=stride, pad=pad)[0]


# ---------------------------------------------------------------------------
# Path selector: packed popcount (bandwidth) vs int8 tensor cores (compute)
# ---------------------------------------------------------------------------

#: H100 SXM HBM rate, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense int8 tensor-core rate, ops/s (NVIDIA's data sheet)
INT8_OPS_PER_S = 1979e12
#: MACs per second the popcount GEMM kernel (B.7) reached at (M, K, N) =
#: (8192, 1024, 4096), measured by ``chip_smoke.py`` on an NVIDIA H100
#: 80GB HBM3 at a 700.00 W power limit
POPCOUNT_MACS_PER_S = 6.328e13


def pick_path(m: int, k: int, n: int) -> str:
    """``"popcount"`` or ``"mxu"``: the path with the lower predicted time
    on an H100, each ``max(bytes / HBM rate, work / its rate)``.  The
    popcount path moves 1-bit activations and two 1-bit weight planes and
    does ``m * k * n`` MACs at the rate B.7 reached; the MXU path moves
    int8 operands and does ``2 * m * k * n`` ops at the int8 tensor-core
    peak."""
    t_pop = max((m * k / 8 + 2 * k * n / 8) / HBM_BYTES_PER_S,
                m * k * n / POPCOUNT_MACS_PER_S)
    t_mxu = max((m * k + k * n) / HBM_BYTES_PER_S,
                2 * m * k * n / INT8_OPS_PER_S)
    return "popcount" if t_pop <= t_mxu else "mxu"
