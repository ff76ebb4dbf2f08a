"""Flexible ping-pong feature SRAM (paper §II-F, Fig. 5).

Four 64Kb single-port SRAM banks form one flat 8192-word (32b) space.  Unlike
a conventional ping-pong buffer (two fixed halves), the IFM read pointer and
OFM write pointer are set *per layer* by PTR instructions, so allocation is
fully flexible: a large feature map may span banks (Fig. 5c), and banks not
addressed by the current layer are powered off (Fig. 5d).

The simulator owns the actual words (the executor reads/writes through it),
checks single-port discipline at layer granularity (IFM region and OFM
region must not share a bank — a shared bank would stall every cycle), and
keeps read/write/energy counters for the power model.

The words are an int32 tensor on one device (the card unless ``device``
says otherwise): each holds the bit pattern of the reference's ``uint32``
word (``mem.view(torch.uint32)``, or ``.numpy().view(np.uint32)`` on the
host), as ``core.quant.pack_bits`` packs them, since CUDA PyTorch has few
``uint32`` ops.  The counters are host-side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import isa, quant
from repro_torch.kernels import ops

WORDS = isa.MAX_ADDR           # 8192 x 32b = 256Kb total
BANK_WORDS = isa.BANK_WORDS    # 2048
N_BANKS = isa.N_BANKS          # 4


def banks_of(addr: int, n_words: int) -> set[int]:
    if n_words <= 0:
        return set()
    first = addr // BANK_WORDS
    last = (addr + n_words - 1) // BANK_WORDS
    return set(range(first, last + 1))


@dataclasses.dataclass
class FmapRef:
    """A feature map stored in the ping-pong space.

    Flat stream layout (position-major, channel-minor):
      fmt='bits': (length, channels) binary, 32 values per word
      fmt='u8'  : (length, channels) 8-bit unsigned, 4 per word
    """

    addr: int
    length: int
    channels: int
    fmt: str = "bits"

    @property
    def n_bits(self) -> int:
        per = 1 if self.fmt == "bits" else 8
        return self.length * self.channels * per

    @property
    def n_words(self) -> int:
        return (self.n_bits + 31) // 32

    @property
    def banks(self) -> set[int]:
        return banks_of(self.addr, self.n_words)


class PingPongSRAM:
    def __init__(self, device=None) -> None:
        self.device = ops.resolve_device(None, device)
        self.mem = torch.zeros(WORDS, dtype=torch.int32, device=self.device)
        self.reads_bits = 0
        self.writes_bits = 0
        self.bank_active_cycles = np.zeros(N_BANKS, dtype=np.int64)

    # -- layer-level discipline checks --------------------------------------

    @staticmethod
    def check_layer(ifm: FmapRef, ofm: FmapRef) -> None:
        """IFM and OFM must fit, not overlap, and not share a bank
        (single-port: one side reads while the other writes)."""
        for ref, name in ((ifm, "IFM"), (ofm, "OFM")):
            if ref.addr < 0 or ref.addr + ref.n_words > WORDS:
                raise MemoryError(
                    f"{name} [{ref.addr}, {ref.addr + ref.n_words}) exceeds "
                    f"{WORDS}-word ping-pong space"
                )
        a0, a1 = ifm.addr, ifm.addr + ifm.n_words
        b0, b1 = ofm.addr, ofm.addr + ofm.n_words
        if max(a0, b0) < min(a1, b1):
            raise MemoryError(f"IFM {a0}:{a1} overlaps OFM {b0}:{b1}")
        shared = ifm.banks & ofm.banks
        if shared:
            raise MemoryError(
                f"single-port violation: IFM banks {sorted(ifm.banks)} and "
                f"OFM banks {sorted(ofm.banks)} share {sorted(shared)}"
            )

    def active_banks(self, ifm: FmapRef, ofm: FmapRef) -> set[int]:
        return ifm.banks | ofm.banks

    def account_layer(self, ifm: FmapRef, ofm: FmapRef, cycles: int) -> None:
        """Charge bank-active cycles for a layer (idle banks powered off)."""
        for b in self.active_banks(ifm, ofm):
            self.bank_active_cycles[b] += cycles

    # -- storage -------------------------------------------------------------

    def _flat(self, ref: FmapRef, vals, per_word: int) -> torch.Tensor:
        """``vals`` (length, channels) as a flat int64 stream on the
        device, zero-padded to ``ref.n_words * per_word`` lanes."""
        v = torch.as_tensor(vals, device=self.device)
        if tuple(v.shape) != (ref.length, ref.channels):
            raise ValueError(f"values {tuple(v.shape)} for a feature map of "
                             f"{(ref.length, ref.channels)}")
        flat = torch.zeros(ref.n_words * per_word, dtype=torch.int64,
                           device=self.device)
        flat[: v.numel()] = v.reshape(-1).to(torch.int64)
        return flat

    def write_bits(self, ref: FmapRef, bits) -> None:
        """bits: (length, channels) 0/1 -> flat packed words at ref.addr."""
        if ref.fmt != "bits":
            raise ValueError(f"write_bits to a {ref.fmt!r} feature map")
        flat = self._flat(ref, bits, 32)
        self.mem[ref.addr : ref.addr + ref.n_words] = quant.pack_bits(flat)
        self.writes_bits += ref.length * ref.channels

    def read_bits(self, ref: FmapRef) -> torch.Tensor:
        """(length, channels) int32 0/1 from the words at ref.addr."""
        if ref.fmt != "bits":
            raise ValueError(f"read_bits from a {ref.fmt!r} feature map")
        words = self.mem[ref.addr : ref.addr + ref.n_words]
        bits = quant.unpack_bits(words)
        self.reads_bits += ref.length * ref.channels
        return bits[: ref.length * ref.channels].reshape(ref.length, ref.channels)

    def write_u8(self, ref: FmapRef, vals) -> None:
        if ref.fmt != "u8":
            raise ValueError(f"write_u8 to a {ref.fmt!r} feature map")
        flat = self._flat(ref, vals, 4) & 0xFF
        shifts = torch.arange(4, dtype=torch.int64, device=self.device) * 8
        words = (flat.reshape(ref.n_words, 4) << shifts).sum(-1)
        words = words - ((words >> 31) << 32)   # [0, 2^32) -> int32 range
        self.mem[ref.addr : ref.addr + ref.n_words] = words.to(torch.int32)
        self.writes_bits += ref.length * ref.channels * 8

    def read_u8(self, ref: FmapRef) -> torch.Tensor:
        """(length, channels) int32 in [0, 256) from the words at
        ref.addr."""
        if ref.fmt != "u8":
            raise ValueError(f"read_u8 from a {ref.fmt!r} feature map")
        words = self.mem[ref.addr : ref.addr + ref.n_words]
        shifts = torch.arange(4, dtype=torch.int32, device=self.device) * 8
        vals = ((words[:, None] >> shifts) & 0xFF).reshape(-1)
        self.reads_bits += ref.length * ref.channels * 8
        return vals[: ref.length * ref.channels].reshape(ref.length, ref.channels)


@dataclasses.dataclass(frozen=True)
class FixedPingPong:
    """Conventional baseline (Fig. 5a): two fixed 128Kb halves.

    Used by the Fig. 5 benchmark to show layers that the fixed scheme cannot
    host but the flexible scheme can.
    """

    half_words: int = WORDS // 2

    def fits(self, ifm: FmapRef, ofm: FmapRef) -> bool:
        return ifm.n_words <= self.half_words and ofm.n_words <= self.half_words
