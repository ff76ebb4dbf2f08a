"""PSCNN 32-bit instruction set (paper §II-A, Fig. 2).

Four instruction types selected by the top 3 bits, exactly as the paper
specifies: MAC, weight replacement (WREP), pointer (PTR), halt (HALT).
The paper gives the field *types* but not the bit-level layout; the layout
below is our reconstruction, chosen so every field of the paper's
description fits in 32 bits (documented in DESIGN.md §1/C3):

MAC   op=000 | fuse(1) | ltype(1) | K(5) | stride_log2(2) | cin_g(6) |
      cout_g(5) | bitser_log2(2) | wpage(4) | pool_log2(2) | outmode(1) |
      spare(3)
  - ltype: 0 = convolution, 1 = standalone pooling (PWB bypass, §II-H)
  - fuse: pool fused into the conv write-back (PWB)
  - K: kernel size 1..31 (pool window when ltype=1; 0 means global pool)
  - stride 2^s (1,2,4,8); cin_g = ceil(Cin/16) stored-1 (Cin<=1024);
    cout_g = ceil(Cout/16) stored-1 (Cout<=512 bitline pairs)
  - bitser: input bit-serial passes 2^b (1,2,4,8) for multi-bit inputs
  - wpage: macro weight-page id the layer reads (set by the compiler)
  - pool_log2: fused pool window 2^p
  - outmode: 0 = SA binary output, 1 = raw counts (bit-serial readout,
    used for the final classifier layer and GAP)

WREP  op=001 | row_start(10) | n_rows(10) | wsram_page(9)
  - copy n_rows macro rows from weight-SRAM page (weight update, §II-G)

PTR   op=010 | ifm_addr(13) | ofm_addr(13) | spare(3)
  - flat word addresses into the 4x64Kb ping-pong space (bank = addr>>11),
    "read starting address of the IFM and the write address of the OFM"

HALT  op=011 | spare(29)
"""
from __future__ import annotations

import dataclasses

OP_MAC, OP_WREP, OP_PTR, OP_HALT = 0, 1, 2, 3
_OP_NAMES = {OP_MAC: "MAC", OP_WREP: "WREP", OP_PTR: "PTR", OP_HALT: "HALT"}

# ping-pong space geometry (paper: four 64Kb single-port SRAMs)
BANK_BITS = 65536  # 64 Kb
N_BANKS = 4
WORD = 32
BANK_WORDS = BANK_BITS // WORD  # 2048
ADDR_BITS = 13  # 4 * 2048 = 8192 words
MAX_ADDR = N_BANKS * BANK_WORDS


def _check(val: int, bits: int, what: str) -> int:
    if not (0 <= val < (1 << bits)):
        raise ValueError(f"{what}={val} does not fit in {bits} bits")
    return val


def _log2(x: int, what: str) -> int:
    if x & (x - 1) or x <= 0:
        raise ValueError(f"{what}={x} must be a power of two")
    return x.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class MacInstr:
    fuse: bool = False
    ltype: int = 0            # 0 conv, 1 standalone pool
    k: int = 1                # kernel/pool size (0 = global pool)
    stride: int = 1
    cin: int = 16             # logical channels (encoded /16)
    cout: int = 16
    bitser: int = 1
    wpage: int = 0
    pool: int = 1             # fused pool window
    outmode: int = 0          # 0 SA binary, 1 raw counts

    def encode(self) -> int:
        cin_g = (self.cin + 15) // 16
        cout_g = (self.cout + 15) // 16
        word = OP_MAC << 29
        word |= _check(int(self.fuse), 1, "fuse") << 28
        word |= _check(self.ltype, 1, "ltype") << 27
        word |= _check(self.k, 5, "k") << 22
        word |= _check(_log2(self.stride, "stride"), 2, "stride") << 20
        word |= _check(cin_g - 1, 6, "cin_g") << 14
        word |= _check(cout_g - 1, 5, "cout_g") << 9
        word |= _check(_log2(self.bitser, "bitser"), 2, "bitser") << 7
        word |= _check(self.wpage, 4, "wpage") << 3
        word |= _check(_log2(self.pool, "pool"), 2, "pool") << 1
        word |= _check(self.outmode, 1, "outmode")
        return word

    @staticmethod
    def decode(word: int) -> "MacInstr":
        return MacInstr(
            fuse=bool((word >> 28) & 1),
            ltype=(word >> 27) & 1,
            k=(word >> 22) & 0x1F,
            stride=1 << ((word >> 20) & 0x3),
            cin=(((word >> 14) & 0x3F) + 1) * 16,
            cout=(((word >> 9) & 0x1F) + 1) * 16,
            bitser=1 << ((word >> 7) & 0x3),
            wpage=(word >> 3) & 0xF,
            pool=1 << ((word >> 1) & 0x3),
            outmode=word & 1,
        )


@dataclasses.dataclass(frozen=True)
class WrepInstr:
    row_start: int
    n_rows: int
    wsram_page: int

    def encode(self) -> int:
        word = OP_WREP << 29
        word |= _check(self.row_start, 10, "row_start") << 19
        word |= _check(self.n_rows, 10, "n_rows") << 9
        word |= _check(self.wsram_page, 9, "wsram_page")
        return word

    @staticmethod
    def decode(word: int) -> "WrepInstr":
        return WrepInstr(
            row_start=(word >> 19) & 0x3FF,
            n_rows=(word >> 9) & 0x3FF,
            wsram_page=word & 0x1FF,
        )


@dataclasses.dataclass(frozen=True)
class PtrInstr:
    ifm_addr: int
    ofm_addr: int

    def encode(self) -> int:
        word = OP_PTR << 29
        word |= _check(self.ifm_addr, ADDR_BITS, "ifm_addr") << 16
        word |= _check(self.ofm_addr, ADDR_BITS, "ofm_addr") << 3
        return word

    @staticmethod
    def decode(word: int) -> "PtrInstr":
        return PtrInstr(
            ifm_addr=(word >> 16) & 0x1FFF,
            ofm_addr=(word >> 3) & 0x1FFF,
        )


@dataclasses.dataclass(frozen=True)
class HaltInstr:
    def encode(self) -> int:
        return OP_HALT << 29

    @staticmethod
    def decode(word: int) -> "HaltInstr":
        return HaltInstr()


Instr = MacInstr | WrepInstr | PtrInstr | HaltInstr


def opcode(word: int) -> int:
    return (word >> 29) & 0x7


def decode(word: int) -> Instr:
    op = opcode(word)
    if op == OP_MAC:
        return MacInstr.decode(word)
    if op == OP_WREP:
        return WrepInstr.decode(word)
    if op == OP_PTR:
        return PtrInstr.decode(word)
    if op == OP_HALT:
        return HaltInstr.decode(word)
    raise ValueError(f"unknown opcode {op:#05b}")


def encode_program(instrs: list[Instr]) -> list[int]:
    return [i.encode() for i in instrs]


def decode_program(words: list[int]) -> list[Instr]:
    out = []
    for w in words:
        i = decode(w)
        out.append(i)
        if isinstance(i, HaltInstr):
            break
    return out


def disassemble(words: list[int]) -> str:
    lines = []
    for pc, w in enumerate(words):
        i = decode(w)
        lines.append(f"{pc:04d}: {w:08x}  {_OP_NAMES[opcode(w)]:<5} {i}")
        if isinstance(i, HaltInstr):
            break
    return "\n".join(lines)
