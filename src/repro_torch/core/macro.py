"""Cycle-level simulator of the 1Mb SRAM CIM macro (paper §II-B/C, Fig. 1).

Geometry (paper): 1024 wordlines x 1024 bitlines, 128 sense amplifiers.
Under TWM (§II-D) adjacent bitlines pair up -> 512 bitline *pairs*; the 128
SAs are 4:1 column-muxed, so one macro read cycle activates up to 1024
wordlines and resolves up to 128 output channels.

The simulator stores the two TWM planes explicitly (what is physically in
the cells) and *computes from the stored cells*, so a mis-scheduled weight
replacement produces wrong activations — exactly the failure mode a real
program would hit.

The cell planes and the weight SRAM's pages are torch tensors on one
device (the card unless ``device`` says otherwise, by
``ops.resolve_device``); the placement bookkeeping (pages, owners) is
host-side.

Pages: the compiler places each layer as one or more column-chunk pages
(<=128 pairs per chunk = one SA group), mirroring "weights with the same
output channel index are placed on the same bitline pair" (Fig. 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

N_ROWS = 1024          # wordlines
N_COLS = 1024          # bitlines (cells per row)
N_PAIRS = N_COLS // 2  # TWM bitline pairs
N_SA = 128             # sense amplifiers -> max pairs resolved per cycle
CELLS = N_ROWS * N_COLS

WEIGHT_SRAM_BITS = 512 * 1024  # §II-G: 512Kb side SRAM
WREP_ROWS_PER_CYCLE = 2        # 2048-bit update bus (DESIGN.md §9)


@dataclasses.dataclass(frozen=True)
class Page:
    """A rectangular weight region: ``rows`` wordlines x ``pairs`` bitline pairs."""

    page_id: int
    row0: int
    pair0: int
    rows: int
    pairs: int

    def __post_init__(self):
        if not (0 <= self.row0 and self.row0 + self.rows <= N_ROWS):
            raise ValueError(f"page {self.page_id}: rows out of range {self}")
        if not (0 <= self.pair0 and self.pair0 + self.pairs <= N_PAIRS):
            raise ValueError(f"page {self.page_id}: pairs out of range {self}")
        if self.pairs > N_SA:
            raise ValueError(
                f"page {self.page_id}: {self.pairs} pairs exceeds one SA group ({N_SA})"
            )

    @property
    def cells(self) -> int:
        return self.rows * self.pairs * 2


class CIMMacro:
    """State + compute of the macro. All compute reads the stored planes."""

    def __init__(self, device=None) -> None:
        self.device = ops.resolve_device(None, device)
        # physical cell planes, pair-indexed: pos/neg of shape (rows, pairs)
        self.pos = torch.zeros((N_ROWS, N_PAIRS), dtype=torch.uint8,
                               device=self.device)
        self.neg = torch.zeros_like(self.pos)
        self.pages: dict[int, Page] = {}
        self._owner = np.full((N_ROWS, N_PAIRS), -1, dtype=np.int32)

    # -- placement ---------------------------------------------------------

    def region_free(self, row0: int, pair0: int, rows: int, pairs: int,
                    ignore: set[int] | None = None) -> bool:
        ignore = ignore or set()
        region = self._owner[row0 : row0 + rows, pair0 : pair0 + pairs]
        used = np.unique(region)
        return all(o == -1 or o in ignore for o in used.tolist())

    def claim(self, page: Page, evict: bool = False) -> list[int]:
        """Register a page; returns the page-ids it evicted (if allowed)."""
        region = self._owner[
            page.row0 : page.row0 + page.rows, page.pair0 : page.pair0 + page.pairs
        ]
        owners = {int(o) for o in np.unique(region) if o != -1}
        if owners and not evict:
            raise ValueError(f"page {page.page_id} overlaps pages {sorted(owners)}")
        for o in owners:
            old = self.pages.pop(o)
            self._owner[old.row0 : old.row0 + old.rows,
                        old.pair0 : old.pair0 + old.pairs] = -1
        self.pages[page.page_id] = page
        region[...] = page.page_id
        return sorted(owners)

    def write_page(self, page_id: int, w_ternary) -> None:
        """Program ternary weights (rows, pairs) into the page's cells."""
        p = self.pages[page_id]
        w = torch.as_tensor(w_ternary, device=self.device)
        if tuple(w.shape) != (p.rows, p.pairs):
            raise ValueError(
                f"page {page_id}: weight shape {tuple(w.shape)} != {(p.rows, p.pairs)}"
            )
        rows = slice(p.row0, p.row0 + p.rows)
        pairs = slice(p.pair0, p.pair0 + p.pairs)
        self.pos[rows, pairs] = (w > 0).to(torch.uint8)
        self.neg[rows, pairs] = (w < 0).to(torch.uint8)

    def read_page(self, page_id: int) -> torch.Tensor:
        """Ternary weights currently held in the page's cells: int32
        (rows, pairs) on the macro's device."""
        p = self.pages[page_id]
        rows = slice(p.row0, p.row0 + p.rows)
        pairs = slice(p.pair0, p.pair0 + p.pairs)
        return (self.pos[rows, pairs].to(torch.int32)
                - self.neg[rows, pairs].to(torch.int32))

    # -- compute -----------------------------------------------------------

    def mac_cycle_count(self, page_id: int, n_positions: int, bitser: int) -> int:
        """Macro read cycles for a layer chunk: one cycle per output position
        per bit-serial pass (the chunk is <=128 pairs = one SA group)."""
        del page_id
        return n_positions * bitser

    def utilization(self, page_id: int) -> float:
        p = self.pages[page_id]
        return (p.rows * p.pairs) / float(N_ROWS * N_SA)

    @property
    def used_cells(self) -> int:
        return int(sum(p.cells for p in self.pages.values()))


class WeightSRAM:
    """512Kb side SRAM holding non-resident pages (§II-G).

    Stores ternary weights at 2 bits each, addressed by wsram page id, as
    int8 tensors on one device (the card unless ``device`` says otherwise).
    """

    def __init__(self, device=None) -> None:
        self.device = ops.resolve_device(None, device)
        self.pages: dict[int, torch.Tensor] = {}

    def store(self, wsram_page: int, w_ternary) -> None:
        self.pages[wsram_page] = torch.as_tensor(
            w_ternary, device=self.device).to(torch.int8)
        if self.used_bits > WEIGHT_SRAM_BITS:
            raise MemoryError(
                f"weight SRAM overflow: {self.used_bits} > {WEIGHT_SRAM_BITS} bits"
            )

    def load(self, wsram_page: int) -> torch.Tensor:
        return self.pages[wsram_page]

    @property
    def used_bits(self) -> int:
        return int(sum(2 * w.numel() for w in self.pages.values()))
