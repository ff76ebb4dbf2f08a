"""Compiler: CNN1DSpec -> macro placement + weight SRAM plan + instruction
stream (paper §II-A/C/G, Fig. 2/4).

Pipeline:
  1. chunk       — split each conv/FC layer's output channels into column
                   chunks of <=128 bitline pairs (one SA group per read).
  2. place       — 2D first-fit-decreasing of fixed chunks onto the
                   1024x512-pair macro.  Chunks named in ``rotate_hints``
                   (or that fail placement) become *rotating*: stored in the
                   512Kb weight SRAM and WREP'd into a shared rotation
                   region right before their MAC executes.  Rotation-region
                   sharing is safe because chunks execute sequentially.
  3. ping-pong   — assign IFM/OFM addresses in the 8192-word feature space,
                   alternating low/high ends (flexible allocation, Fig. 5).
  4. emit        — PTR / WREP / MAC / HALT stream + binding table.

Residency planning is 2D bin packing + scheduling (NP-hard); like real
accelerator toolchains we take a good heuristic plus optional placement
pragmas (``rotate_hints`` / ``rowsplit_hints``).  Row-splitting is legal
only for raw-output layers (outmode=1): their digital readout counters can
accumulate row-group partials, whereas SA-binarized layers must see the full
receptive field on one bitline pair (the paper's no-partial-sum principle).

Placement and emission are host-side; the macro's cell planes, the weight
SRAM's pages, the weights and the SA parameters the program carries are
tensors on one device (``device=``, the card by default).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import isa, macro
from repro_torch.core.cnn_spec import (
    CNN1DSpec,
    Conv1DSpec,
    FCSpec,
    GAPSpec,
    PoolSpec,
)
from repro_torch.kernels import ops


@dataclasses.dataclass
class Chunk:
    """One column chunk of a layer: ``pairs`` output channels on one SA group."""

    name: str
    layer_idx: int
    exec_idx: int
    rows: int             # wordlines = Cin*K (or a row-split slice)
    pairs: int            # padded output-channel count (multiple of 16)
    ch0: int              # first logical output channel
    ch1: int              # one past last logical output channel
    row0_w: int = 0       # first weight row (for row-splits)
    rotating: bool = False
    page_id: int = -1
    placed: tuple[int, int] | None = None  # (row0, pair0)
    wsram_page: int = -1

    @property
    def weights(self) -> int:
        return self.rows * self.pairs


@dataclasses.dataclass
class LayerBinding:
    """Everything the executor needs to run one layer."""

    layer_idx: int
    spec: object
    chunks: list[Chunk]
    ifm_addr: int = 0
    ofm_addr: int = 0


@dataclasses.dataclass
class CompiledProgram:
    spec: CNN1DSpec
    words: list[int]
    bindings: list[LayerBinding]
    instr_meta: list[tuple[str, object]]  # (kind, payload) per instruction
    cim: macro.CIMMacro
    wsram: macro.WeightSRAM
    rotation_region: tuple[int, int, int, int] | None  # row0, pair0, rows, pairs
    # layer -> (thr float64, flip bool) (Cout,) tensors
    thresholds: dict[int, tuple[torch.Tensor, torch.Tensor]]
    weights: dict[int, torch.Tensor]  # layer -> ternary weights
    in_addr: int = 0

    @property
    def device(self) -> torch.device:
        """The device the macro and feature SRAM images lie on."""
        return self.cim.device

    def disassemble(self) -> str:
        return isa.disassemble(self.words)


def _pad16(x: int) -> int:
    return ((x + 15) // 16) * 16


def chunk_layer(spec, layer_idx: int, exec_base: int, rowsplit: int = 1) -> list[Chunk]:
    """Split a conv/FC layer into <=128-pair column chunks (x row splits)."""
    if isinstance(spec, Conv1DSpec):
        cout, rows = spec.cout, spec.rows
    elif isinstance(spec, FCSpec):
        cout, rows = spec.cout, spec.rows
    else:
        return []
    n_col = max(1, -(-cout // macro.N_SA))
    chunks: list[Chunk] = []
    e = exec_base
    for rs in range(rowsplit):
        r0 = rs * (rows // rowsplit)
        r1 = rows if rs == rowsplit - 1 else (rs + 1) * (rows // rowsplit)
        for c in range(n_col):
            # SA-group-sized chunks: 128, 128, ..., remainder
            ch0, ch1 = c * macro.N_SA, min((c + 1) * macro.N_SA, cout)
            chunks.append(
                Chunk(
                    name=f"{spec.name}.r{rs}c{c}" if rowsplit > 1 else f"{spec.name}.c{c}",
                    layer_idx=layer_idx,
                    exec_idx=e,
                    rows=r1 - r0,
                    pairs=_pad16(ch1 - ch0),
                    ch0=ch0,
                    ch1=ch1,
                    row0_w=r0,
                )
            )
            e += 1
    return chunks


class _Grid:
    """First-fit 2D occupancy over (1024 rows x 512 pairs)."""

    def __init__(self) -> None:
        self.occ = np.zeros((macro.N_ROWS, macro.N_PAIRS), dtype=bool)

    def place(self, rows: int, pairs: int) -> tuple[int, int] | None:
        """16-aligned first-fit scan (row-major)."""
        for r0 in range(0, macro.N_ROWS - rows + 1, 16):
            for p0 in range(0, macro.N_PAIRS - pairs + 1, 16):
                if not self.occ[r0 : r0 + rows, p0 : p0 + pairs].any():
                    self.occ[r0 : r0 + rows, p0 : p0 + pairs] = True
                    return (r0, p0)
        return None


def compile_model(
    spec: CNN1DSpec,
    weights: dict[int, np.ndarray],
    thresholds: dict[int, tuple[np.ndarray, np.ndarray]],
    rotate_hints: tuple[str, ...] = (),
    rowsplit_hints: dict[str, int] | None = None,
    device=None,
) -> CompiledProgram:
    """Plan placement + emit the instruction stream for one model.

    weights[layer_idx]: (K, Cin, Cout) or (Cin, Cout) ternary int arrays
    (numpy or tensors; a conv's may also be (K * Cin, Cout)).
    thresholds[layer_idx]: (thr, flip) arrays of length Cout (SA offsets);
    the thresholds stay float64, as exported.
    device: where the macro and weight-SRAM images, the weights and the
    SA parameters go (default: the card, by ``ops.resolve_device``).
    """
    device = ops.resolve_device(None, device)
    weights = {k: torch.as_tensor(v, device=device)
               for k, v in weights.items()}
    thresholds = {k: (torch.as_tensor(t, device=device).to(torch.float64),
                      torch.as_tensor(f, device=device).to(torch.bool))
                  for k, (t, f) in thresholds.items()}
    rowsplit_hints = rowsplit_hints or {}
    shapes = spec.trace_shapes()

    # ---- 1. chunk ----------------------------------------------------------
    all_chunks: list[Chunk] = []
    per_layer: dict[int, list[Chunk]] = {}
    e = 0
    for li, lspec in enumerate(spec.layers):
        rs = rowsplit_hints.get(getattr(lspec, "name", ""), 1)
        if rs > 1 and not getattr(lspec, "out_raw", False):
            raise ValueError(
                f"{lspec.name}: row-split needs raw output (digital accumulation)"
            )
        cs = chunk_layer(lspec, li, e, rowsplit=rs)
        e += len(cs)
        per_layer[li] = cs
        all_chunks.extend(cs)

    # ---- 2. residency + placement -----------------------------------------
    rotating = [c for c in all_chunks if c.name in rotate_hints]
    for c in rotating:
        c.rotating = True
    fixed = [c for c in all_chunks if not c.rotating]

    grid = _Grid()
    region = None
    if rotating:
        rr = max(c.rows for c in rotating)
        rp = max(c.pairs for c in rotating)
        pos = grid.place(rr, rp)
        if pos is None:
            raise MemoryError("cannot place rotation region")
        region = (pos[0], pos[1], rr, rp)

    retry: list[Chunk] = []
    for c in sorted(fixed, key=lambda c: -(c.rows * c.pairs)):
        pos = grid.place(c.rows, c.pairs)
        if pos is None:
            retry.append(c)
        else:
            c.placed = pos
    # chunks that failed fixed placement fall back to rotating (auto mode)
    for c in sorted(retry, key=lambda c: c.exec_idx):
        c.rotating = True
        rotating.append(c)
        if region is None or c.rows > region[2] or c.pairs > region[3]:
            rr = max(region[2] if region else 0, c.rows)
            rp = max(region[3] if region else 0, c.pairs)
            pos = grid.place(rr, rp)
            if pos is None:
                raise MemoryError(
                    f"chunk {c.name} fits neither fixed nor rotation region; "
                    "add rotate_hints or shrink the model"
                )
            region = (pos[0], pos[1], rr, rp)
    rotating.sort(key=lambda c: c.exec_idx)

    # ---- 3. build macro + weight SRAM images ------------------------------
    cim = macro.CIMMacro(device)
    wsram = macro.WeightSRAM(device)
    page_id = 0
    wsram_page = 0

    def chunk_weights(c: Chunk) -> torch.Tensor:
        w = weights[c.layer_idx]
        w2 = w.reshape(-1, w.shape[-1]) if w.ndim == 3 else w
        sl = w2[c.row0_w : c.row0_w + c.rows, c.ch0 : c.ch1]
        out = torch.zeros((c.rows, c.pairs), dtype=torch.int8, device=device)
        out[:, : c.ch1 - c.ch0] = sl.to(torch.int8)
        return out

    for c in all_chunks:
        c.page_id = page_id
        page_id += 1
        if c.rotating:
            c.wsram_page = wsram_page
            wsram.store(wsram_page, chunk_weights(c))
            wsram_page += 1
        else:
            assert c.placed is not None
            cim.claim(macro.Page(c.page_id, c.placed[0], c.placed[1], c.rows, c.pairs))
            cim.write_page(c.page_id, chunk_weights(c))

    # ---- 4. ping-pong addresses + instruction emission ---------------------
    words: list[int] = []
    meta: list[tuple[str, object]] = []
    bindings: list[LayerBinding] = []

    def fmap_words(length: int, channels: int, fmt: str) -> int:
        bits = length * channels * (1 if fmt == "bits" else 8)
        return (bits + 31) // 32

    in_fmt = "u8" if spec.in_bits > 1 else "bits"
    cur_addr = 0  # input lives at the low end
    cur_words = fmap_words(spec.in_len, spec.in_channels, in_fmt)
    low_side = False  # next OFM goes to the high end
    l, c_ch = spec.in_len, spec.in_channels

    for li, lspec in enumerate(spec.layers):
        out_l, out_c = shapes[li]
        if isinstance(lspec, (Conv1DSpec, FCSpec)):
            out_fmt = "u8" if getattr(lspec, "out_raw", False) else "bits"
        elif isinstance(lspec, GAPSpec):
            out_fmt = "u8"
        else:
            out_fmt = "bits"
        out_words = fmap_words(out_l, out_c, out_fmt)
        ofm_addr = 0 if low_side else isa.MAX_ADDR - out_words
        if ofm_addr < 0 or cur_words + out_words > isa.MAX_ADDR:
            raise MemoryError(
                f"layer {li}: IFM {cur_words}w + OFM {out_words}w exceeds "
                f"{isa.MAX_ADDR}-word ping-pong space"
            )
        b = LayerBinding(li, lspec, per_layer[li], ifm_addr=cur_addr, ofm_addr=ofm_addr)
        bindings.append(b)

        words.append(isa.PtrInstr(ifm_addr=cur_addr, ofm_addr=ofm_addr).encode())
        meta.append(("ptr", b))

        if isinstance(lspec, (Conv1DSpec, FCSpec)):
            for ch in per_layer[li]:
                if ch.rotating:
                    r0, p0, _, _ = region
                    words.append(
                        isa.WrepInstr(
                            row_start=r0, n_rows=ch.rows, wsram_page=ch.wsram_page
                        ).encode()
                    )
                    meta.append(("wrep", ch))
                mi = isa.MacInstr(
                    fuse=getattr(lspec, "pool", 1) > 1,
                    ltype=0,
                    k=lspec.k if isinstance(lspec, Conv1DSpec) else 1,
                    stride=lspec.stride if isinstance(lspec, Conv1DSpec) else 1,
                    cin=_pad16(lspec.cin),
                    cout=ch.pairs,
                    bitser=lspec.in_bits,
                    wpage=ch.page_id % 16,
                    pool=getattr(lspec, "pool", 1),
                    outmode=1 if getattr(lspec, "out_raw", False) else 0,
                )
                words.append(mi.encode())
                meta.append(("mac", (b, ch)))
        elif isinstance(lspec, PoolSpec):
            words.append(
                isa.MacInstr(
                    ltype=1, k=lspec.pool, cin=_pad16(lspec.channels),
                    cout=_pad16(lspec.channels), pool=1,
                ).encode()
            )
            meta.append(("pool", b))
        elif isinstance(lspec, GAPSpec):
            words.append(
                isa.MacInstr(
                    ltype=1, k=0, cin=_pad16(lspec.channels),
                    cout=_pad16(lspec.channels), outmode=1,
                ).encode()
            )
            meta.append(("gap", b))

        cur_addr, cur_words = ofm_addr, out_words
        low_side = not low_side
        l, c_ch = out_l, out_c

    words.append(isa.HaltInstr().encode())
    meta.append(("halt", None))

    return CompiledProgram(
        spec=spec,
        words=words,
        bindings=bindings,
        instr_meta=meta,
        cim=cim,
        wsram=wsram,
        rotation_region=region,
        thresholds=thresholds,
        weights=weights,
        in_addr=0,
    )
