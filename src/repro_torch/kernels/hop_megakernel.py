"""Hop megakernel: one launch per streaming KWS hop, CUDA on Hopper.

The port of the reference's Pallas megakernel
(``repro/kernels/hop_megakernel.py``: ``hop_megakernel_packed`` and
``finalize_megakernel_packed``, body ``_megakernel``).  One fused launch
runs the whole hop for every slot: the bit-serial first layer, each conv
stage's K-tap conv, SA binarization and max-pool with the pool-phase
carry, the receptive-field tail carry, GAP accumulation saturated at 255,
the masked-slot merge, and — on emit hops — the ghost end-of-stream flush
and the fc classifier on the merged state.  ``finalize_megakernel_packed``
is the same kernel in peek mode: flush + classifier from resident state.

Two versions of the same function live here:

* the CUDA kernel (``csrc/hop_megakernel.cu``), one CTA per slot with the
  feature maps in shared memory, launched on the current stream for CUDA
  tensors; a build or launch failure raises, there is no fallback;
* the plain PyTorch version (``hop_megakernel_plain`` /
  ``finalize_megakernel_plain``), the twin of ``_megakernel``.  It runs
  for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel
  against it.

The packed entry points take the reference's packed operands: one tail per
stage with ``tail > 0`` and one pending per stage with ``phase > 0``
(``kernels/ops.py`` filters the zero-width ones), int8 ternary weights
``([K,] k, cin, cout)``, float32 thresholds and int32 flips ``([K,] C)``,
and with a tenant pool a per-slot ``(B,)`` int32 model index.  Binary
stages' state holds {0, 1} values (the kernel keeps them as int8).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, dispatch

HOP_KERNEL = "hop_megakernel"
FINALIZE_KERNEL = "finalize_megakernel"
THREADS = 256
MAX_STAGES = 8
MAX_FC = 4
MAX_SMEM = 232448  # opt-in shared memory per block on H100 (227 KB)


@dataclasses.dataclass(frozen=True)
class StageGeom:
    """One conv stage's static geometry — the subset of the stream plan's
    ``ConvStage`` the kernel needs, so the kernel layer never imports the
    stream runtime.  ``n_in`` (frames consumed per hop) sizes the window."""

    k: int
    stride: int
    pad: int
    pool: int
    cin: int
    cout: int
    in_bits: int
    in_offset: int
    tail: int
    phase: int
    n_in: int
    n_conv: int
    n_out: int
    flush_in: int
    flush_conv: int
    flush_out: int


def stage_geom(st) -> StageGeom:
    """Build a :class:`StageGeom` from anything with ConvStage's fields."""
    return StageGeom(**{f.name: getattr(st, f.name)
                        for f in dataclasses.fields(StageGeom)})


# ---------------------------------------------------------------------------
# Plain PyTorch version (the twin of the reference's ``_megakernel``)
# ---------------------------------------------------------------------------

def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer contraction, exact: float64 holds every partial sum of these
    layers (all < 2^53), and CUDA has no int32 GEMM."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def _codes(g: StageGeom, window: torch.Tensor) -> torch.Tensor:
    """Bit-serial first layer: ``sum_b ((x >> b) & 1) << b`` over the
    ``in_bits`` planes is ``x & (2^in_bits - 1)``; minus the offset."""
    if g.in_bits > 1:
        return (window & ((1 << g.in_bits) - 1)) - g.in_offset
    return window


def _conv_raw(g: StageGeom, w, window, n_pos: int) -> torch.Tensor:
    """(b, L, cin) int32 window -> (b, n_pos, cout) int32 raw conv."""
    x = _codes(g, window)
    span = (n_pos - 1) * g.stride + 1
    taps = torch.stack([x[:, t:t + span:g.stride] for t in range(g.k)], 1)
    return _contract("bknc,kco->bno", taps, w)


def _sa(raw, thr, flip) -> torch.Tensor:
    """SA binarization: float32 compare (integer thresholds, maybe ±inf)
    xor the per-channel flip."""
    ge = raw.to(torch.float32) >= thr
    return (ge ^ (flip != 0)).to(torch.int32)


def _pool(frames, n_out: int, pool: int) -> torch.Tensor:
    b, _, c = frames.shape
    return frames[:, :n_out * pool].reshape(b, n_out, pool, c).amax(2)


def _gap_add(gap, cur) -> torch.Tensor:
    return torch.clamp(gap + cur.sum(1, dtype=torch.int32), max=255)


def _steady_cascade(geoms, cur, tails, pends, ws, thrs, flips):
    new_tails, new_pends = [], []
    for i, g in enumerate(geoms):
        window = torch.cat([tails[i], cur], 1)
        raw = _conv_raw(g, ws[i], window, g.n_conv)
        new_tails.append(window[:, g.n_conv * g.stride:])
        y = _sa(raw, thrs[i], flips[i])
        if g.pool > 1:
            frames = torch.cat([pends[i], y], 1)
            used = g.n_out * g.pool
            new_pends.append(frames[:, used:])
            cur = _pool(frames, g.n_out, g.pool)
        else:
            new_pends.append(pends[i])
            cur = y
    return cur, new_tails, new_pends


def _flush_cascade(geoms, tails, pends, gap, ws, thrs, flips):
    """Ghost end-of-stream flush -> saturated GAP counts."""
    b = gap.shape[0]
    cur = None
    for i, g in enumerate(geoms):
        pieces = [tails[i]]
        if cur is not None and g.flush_in:
            pieces.append(cur)
        if g.pad:
            pad_val = g.in_offset if g.in_bits > 1 else 0
            pieces.append(torch.full((b, g.pad, g.cin), pad_val,
                                     dtype=torch.int32, device=gap.device))
        if g.flush_conv > 0:
            y = _sa(_conv_raw(g, ws[i], torch.cat(pieces, 1), g.flush_conv),
                    thrs[i], flips[i])
        else:
            y = torch.zeros((b, 0, g.cout), dtype=torch.int32,
                            device=gap.device)
        cur = _pool(torch.cat([pends[i], y], 1), g.flush_out, g.pool)
    return _gap_add(gap, cur)


def _classifier(gap_f, fc_ws, fc_thrs, fc_flips, fc_raw) -> torch.Tensor:
    h = torch.clamp(gap_f, max=255)
    for w, thr, flip, raw_out in zip(fc_ws, fc_thrs, fc_flips, fc_raw):
        raw = _contract("bc,co->bo", h, w)
        h = raw if raw_out else _sa(raw, thr, flip)
    return h


def _full_state(geoms, tails, pendings, b, device):
    """Packed (non-zero-width only) tails/pendings -> one entry per stage."""
    ti, pi = iter(tails), iter(pendings)
    z = lambda n, c: torch.zeros((b, n, c), dtype=torch.int32,  # noqa: E731
                                 device=device)
    full_t = [next(ti) if g.tail else z(0, g.cin) for g in geoms]
    full_p = [next(pi) if g.phase else z(0, g.cout) for g in geoms]
    return full_t, full_p


def _one_model(audio, mask, tails, pends, gap, params, geoms, emit, fc_raw,
               finalize_only):
    ws, thrs, flips, fc_ws, fc_thrs, fc_flips = params
    if finalize_only:
        gap_f = _flush_cascade(geoms, tails, pends, gap, ws, thrs, flips)
        return None, None, None, _classifier(gap_f, fc_ws, fc_thrs,
                                             fc_flips, fc_raw)
    cur, new_tails, new_pends = _steady_cascade(
        geoms, audio, tails, pends, ws, thrs, flips)
    gap2 = _gap_add(gap, cur)
    m = mask != 0
    m3 = m[:, None, None]
    tails = [torch.where(m3, nt, t) for nt, t in zip(new_tails, tails)]
    pends = [torch.where(m3, npd, p) for npd, p in zip(new_pends, pends)]
    gap = torch.where(m[:, None], gap2, gap)
    logits = None
    if emit:
        gap_f = _flush_cascade(geoms, tails, pends, gap, ws, thrs, flips)
        logits = _classifier(gap_f, fc_ws, fc_thrs, fc_flips, fc_raw)
    return tails, pends, gap, logits


def _plain(audio, mask, tails, pendings, gap, params, model_idx, *, geoms,
           emit, fc_raw, finalize_only):
    b = gap.shape[0]
    full_t, full_p = _full_state(geoms, tails, pendings, b, gap.device)
    if model_idx is None:
        out = _one_model(audio, mask, full_t, full_p, gap, params, geoms,
                         emit, fc_raw, finalize_only)
    else:
        # tenant pool: each model's rows run with that model's weights
        out_t = [t.clone() for t in full_t]
        out_p = [p.clone() for p in full_p]
        out_g = gap.clone()
        out_l = None
        for mdl in torch.unique(model_idx).tolist():
            rows = torch.nonzero(model_idx == mdl).reshape(-1)
            sel = lambda x: None if x is None else x.index_select(0, rows)  # noqa: E731,E501
            t, p, g, lg = _one_model(
                sel(audio), sel(mask), [sel(t) for t in full_t],
                [sel(p) for p in full_p], sel(gap),
                tuple(tuple(x[mdl] for x in grp) for grp in params),
                geoms, emit, fc_raw, finalize_only)
            if t is not None:
                for dst, src in zip(out_t + out_p + [out_g], t + p + [g]):
                    dst[rows] = src
            if lg is not None:
                if out_l is None:
                    out_l = torch.empty((b, lg.shape[1]), dtype=torch.int32,
                                        device=gap.device)
                out_l[rows] = lg
        out = out_t, out_p, out_g, out_l
    tails_o, pends_o, gap_o, logits = out
    if finalize_only:
        return logits
    packed_t = tuple(t for g, t in zip(geoms, tails_o) if g.tail)
    packed_p = tuple(p for g, p in zip(geoms, pends_o) if g.phase)
    if emit:
        return packed_t, packed_p, gap_o, logits
    return packed_t, packed_p, gap_o


def hop_megakernel_plain(audio, mask, tails, pendings, gap, ws, thrs, flips,
                         fc_ws=(), fc_thrs=(), fc_flips=(), model_idx=None,
                         *, geoms, emit, fc_raw=()):
    """Plain PyTorch version of :func:`hop_megakernel_packed` (any
    device).  Returns ``(tails, pendings, gap[, logits])``."""
    params = (ws, thrs, flips, fc_ws, fc_thrs, fc_flips)
    return _plain(audio, mask, tails, pendings, gap, params, model_idx,
                  geoms=geoms, emit=emit, fc_raw=fc_raw, finalize_only=False)


def finalize_megakernel_plain(tails, pendings, gap, ws, thrs, flips, fc_ws,
                              fc_thrs, fc_flips, model_idx=None, *, geoms,
                              fc_raw):
    """Plain PyTorch version of :func:`finalize_megakernel_packed`."""
    params = (ws, thrs, flips, fc_ws, fc_thrs, fc_flips)
    return _plain(None, None, tails, pendings, gap, params, model_idx,
                  geoms=geoms, emit=True, fc_raw=fc_raw, finalize_only=True)


# ---------------------------------------------------------------------------
# The CUDA kernel: parameter block, shared-memory layout, launch
# ---------------------------------------------------------------------------

_INT_FIELDS = ("k", "stride", "pad", "pool", "cin", "cout", "in_bits",
               "in_offset", "tail", "phase", "n_in", "n_conv", "n_out",
               "flush_in", "flush_conv", "flush_out")


class _Stage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _INT_FIELDS] + [
        (n, ctypes.c_void_p) for n in ("tail_in", "tail_out", "pend_in",
                                       "pend_out", "w", "thr", "flip")]


class _Fc(ctypes.Structure):
    _fields_ = [("cin", ctypes.c_int), ("cout", ctypes.c_int),
                ("raw", ctypes.c_int), ("unused", ctypes.c_int),
                ("w", ctypes.c_void_p), ("thr", ctypes.c_void_p),
                ("flip", ctypes.c_void_p)]


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_stages", "n_fc", "emit", "finalize_only", "gap_c", "n_logits",
        "win0_elems", "bin_bytes", "frm_bytes", "fc_elems")] + [
        (n, ctypes.c_void_p) for n in ("audio", "mask", "gap_in", "gap_out",
                                       "logits", "model_idx")] + [
        ("st", _Stage * MAX_STAGES), ("fc", _Fc * MAX_FC)]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def smem_layout(geoms: tuple[StageGeom, ...], fc_dims, gap_c: int
                ) -> tuple[int, int, int, int, int]:
    """Shared-memory buffers of one CTA: ``(win0_elems, bin_bytes,
    frm_bytes, fc_elems, total_bytes)``.  The layer-0 window is int32; the
    two ping-pong windows and the frames buffer hold binary maps as int8,
    each sized for the larger of the steady and the flush cascade."""
    g0 = geoms[0]
    win0 = -(-g0.cin * (g0.tail + max(g0.n_in, g0.pad)) // 4) * 4
    bin_ = 1
    for g in geoms[1:]:
        bin_ = max(bin_, (g.tail + max(g.n_in, g.flush_in + g.pad)) * g.cin)
    gl = geoms[-1]
    bin_ = max(bin_, max(gl.n_out, gl.flush_out) * gl.cout)
    frm = max((g.phase + max(g.n_conv, g.flush_conv)) * g.cout
              for g in geoms)
    fc = max([gap_c] + [d for dims in fc_dims for d in dims])
    bin_, frm = _round16(bin_), _round16(max(frm, 1))
    total = win0 * 4 + 2 * bin_ + frm + 2 * fc * 4
    return win0, bin_, frm, fc, total


def _lib():
    lib = build.load(HOP_KERNEL)
    if not getattr(lib, "_hop_ready", False):
        lib.hop_megakernel_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.hop_megakernel_launch.restype = ctypes.c_int
        lib.hop_megakernel_params_size.restype = ctypes.c_int
        size = lib.hop_megakernel_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"hop kernel parameter block is {size} bytes in CUDA, "
                f"{ctypes.sizeof(_Params)} in Python")
        lib._hop_ready = True
    return lib


def _check(x: torch.Tensor, name: str, dtype, shape) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return x.data_ptr()


def _launch(audio, mask, tails, pendings, gap, ws, thrs, flips, fc_ws,
            fc_thrs, fc_flips, model_idx, *, geoms, emit, fc_raw,
            finalize_only):
    ns, nf = len(geoms), len(fc_raw)
    if not 1 <= ns <= MAX_STAGES or nf > MAX_FC:
        raise ValueError(f"kernel takes 1..{MAX_STAGES} conv stages and at "
                         f"most {MAX_FC} fc layers; got {ns} and {nf}")
    if any(g.in_bits > 8 for g in geoms[1:]):
        # later stages' windows are int8: a raw input kept mod 256 still
        # gives the code of an in_bits <= 8 stage, not of a wider one
        raise ValueError("the CUDA kernel keeps the windows of conv stages "
                         "past the first as int8, so their bit-serial "
                         "inputs must have in_bits <= 8")
    b, gap_c = gap.shape
    dev = gap.device
    pooled = model_idx is not None
    lead = (ws[0].shape[0],) if pooled else ()
    p = _Params()
    p.n_stages, p.n_fc = ns, nf
    p.emit, p.finalize_only = int(emit), int(finalize_only)
    p.gap_c = gap_c
    p.gap_in = _check(gap, "gap", torch.int32, (b, gap_c))
    if pooled:
        p.model_idx = _check(model_idx, "model_idx", torch.int32, (b,))
    if not finalize_only:
        g0 = geoms[0]
        p.audio = _check(audio, "audio", torch.int32, (b, g0.n_in, g0.cin))
        p.mask = _check(mask, "mask", torch.int32, (b,))
    ti = pi = 0
    tails_out, pends_out = [], []
    for i, g in enumerate(geoms):
        s = p.st[i]
        for f in _INT_FIELDS:
            setattr(s, f, getattr(g, f))
        s.w = _check(ws[i], f"ws[{i}]", torch.int8, lead + (g.k, g.cin, g.cout))
        s.thr = _check(thrs[i], f"thrs[{i}]", torch.float32, lead + (g.cout,))
        s.flip = _check(flips[i], f"flips[{i}]", torch.int32, lead + (g.cout,))
        if g.tail:
            s.tail_in = _check(tails[ti], f"tails[{ti}]", torch.int32,
                               (b, g.tail, g.cin))
            ti += 1
            if not finalize_only:
                t = torch.empty((b, g.tail, g.cin), dtype=torch.int32,
                                device=dev)
                s.tail_out = t.data_ptr()
                tails_out.append(t)
        if g.phase:
            s.pend_in = _check(pendings[pi], f"pendings[{pi}]", torch.int32,
                               (b, g.phase, g.cout))
            pi += 1
            if not finalize_only:
                t = torch.empty((b, g.phase, g.cout), dtype=torch.int32,
                                device=dev)
                s.pend_out = t.data_ptr()
                pends_out.append(t)
    if ti != len(tails) or pi != len(pendings):
        raise ValueError("tails/pendings do not match the stages' widths")
    with_fc = emit or finalize_only
    fc_dims = []
    if with_fc:
        for j, raw in enumerate(fc_raw):
            f = p.fc[j]
            cin, cout = fc_ws[j].shape[-2:]
            f.cin, f.cout, f.raw = cin, cout, int(raw)
            f.w = _check(fc_ws[j], f"fc_ws[{j}]", torch.int8,
                         lead + (cin, cout))
            if not raw:
                f.thr = _check(fc_thrs[j], f"fc_thrs[{j}]", torch.float32,
                               lead + (cout,))
                f.flip = _check(fc_flips[j], f"fc_flips[{j}]", torch.int32,
                                lead + (cout,))
            fc_dims.append((cin, cout))
        p.n_logits = fc_dims[-1][1] if fc_dims else gap_c
        logits = torch.empty((b, p.n_logits), dtype=torch.int32, device=dev)
        p.logits = logits.data_ptr()
    else:
        p.n_fc = 0
    gap_out = None
    if not finalize_only:
        gap_out = torch.empty((b, gap_c), dtype=torch.int32, device=dev)
        p.gap_out = gap_out.data_ptr()
    (p.win0_elems, p.bin_bytes, p.frm_bytes, p.fc_elems,
     smem) = smem_layout(geoms, fc_dims, gap_c)
    if smem > MAX_SMEM:
        raise ValueError(f"plan needs {smem} B of shared memory per slot, "
                         f"more than the {MAX_SMEM} B a block can have")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().hop_megakernel_launch(ctypes.byref(p), b, THREADS, smem,
                                          stream)
    if rc != 0:
        raise RuntimeError(f"hop megakernel launch failed: CUDA error {rc}")
    if finalize_only:
        return logits
    if emit:
        return tuple(tails_out), tuple(pends_out), gap_out, logits
    return tuple(tails_out), tuple(pends_out), gap_out


def hop_megakernel_packed(audio, mask, tails, pendings, gap, ws, thrs, flips,
                          fc_ws=(), fc_thrs=(), fc_flips=(), model_idx=None,
                          *, geoms, emit, fc_raw=()):
    """One fused hop, ONE launch: ``(tails, pendings, gap[, logits])``.

    For CUDA tensors this launches the CUDA kernel (and raises on any
    failure); for CPU tensors the plain version stands in for it.  Either
    way it counts one ``hop_megakernel`` dispatch."""
    if gap.device.type == "cpu":
        dispatch.record(HOP_KERNEL)
        return hop_megakernel_plain(
            audio, mask, tails, pendings, gap, ws, thrs, flips, fc_ws,
            fc_thrs, fc_flips, model_idx, geoms=geoms, emit=emit,
            fc_raw=fc_raw)
    out = _launch(audio, mask, tails, pendings, gap, ws, thrs, flips, fc_ws,
                  fc_thrs, fc_flips, model_idx, geoms=geoms, emit=emit,
                  fc_raw=fc_raw, finalize_only=False)
    dispatch.record(HOP_KERNEL)
    return out


def finalize_megakernel_packed(tails, pendings, gap, ws, thrs, flips, fc_ws,
                               fc_thrs, fc_flips, model_idx=None, *, geoms,
                               fc_raw):
    """Ghost flush + classifier from resident state, ONE launch: int32
    logits ``(B, n_classes)``.  CPU tensors take the plain version."""
    if gap.device.type == "cpu":
        dispatch.record(FINALIZE_KERNEL)
        return finalize_megakernel_plain(
            tails, pendings, gap, ws, thrs, flips, fc_ws, fc_thrs, fc_flips,
            model_idx, geoms=geoms, fc_raw=fc_raw)
    out = _launch(None, None, tails, pendings, gap, ws, thrs, flips, fc_ws,
                  fc_thrs, fc_flips, model_idx, geoms=geoms, emit=True,
                  fc_raw=fc_raw, finalize_only=True)
    dispatch.record(FINALIZE_KERNEL)
    return out
