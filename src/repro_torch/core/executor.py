"""Instruction-stream executor: the system controller + CIM core (Fig. 1).

Walks the compiled program word by word, decoding each instruction exactly as
the hardware controller would, and executes it against the simulated state:

  PTR   -> latch IFM/OFM pointers
  WREP  -> weight SRAM -> macro rotation region (claim+program the page)
  MAC   -> stream the IFM through the line buffer, activate the chunk's
           wordlines, read SA outputs (or raw counts), PWB pool, write OFM
  HALT  -> stop

All MAC arithmetic is computed FROM THE MACRO CELL STATE (`read_page`), so a
mis-scheduled WREP yields wrong activations, like silicon would.  Cycle and
energy charges follow DESIGN.md §1/§9; the ledger reproduces Table I.

``fuse_pool=False`` runs the paper's baseline: pooling executes as a separate
pass through the PWB bypass (extra SRAM traffic + cycles) instead of fused
into the conv write-back — the §II-H latency-reduction experiment.

The executor runs on the device its program lies on (``compile_model``'s
``device=``).  Each MAC chunk is ONE launch of a hand-written kernel through
``kernels/ops.py`` (the plain PyTorch version on CPU tensors):

  bit-serial conv (first layer)  -> ``ops.bitserial_conv1d``          (B.3)
  binary conv                    -> ``ops.bnn_conv1d``, raw mode      (B.6)
  bit-serial FC                  -> the input's bit planes as the rows of
                                    one ``ops.twm_linear`` raw call,
                                    weighted 2^b, less offset * sum(w) (B.7)
  binary FC (row slice)          -> ``ops.twm_linear``, raw mode      (B.7)

The SA compare, the raw accumulation, pooling and the feature SRAM's words
are small torch ops on the same device.  The ledger and the cycle counts
are Python ints computed from shapes, never tensors, so charging them
never waits for the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import isa, macro, pwb
from repro_torch.core.cnn_spec import FCSpec
from repro_torch.core.compiler import Chunk, CompiledProgram, LayerBinding
from repro_torch.core.energy import EnergyLedger, EnergyParams
from repro_torch.core.pingpong import FmapRef, PingPongSRAM
from repro_torch.kernels import ops

READOUT_CYCLES = 8  # thermometer SA sweep per raw-output position per chunk


@dataclasses.dataclass
class ExecutionReport:
    """``output`` and ``fmaps`` are int64 tensors on the program's device;
    the ledger, ``layer_cycles`` and ``bank_active_cycles`` (numpy int64)
    are host-side."""

    output: torch.Tensor
    ledger: EnergyLedger
    layer_cycles: dict[str, int]
    bank_active_cycles: np.ndarray
    fmaps: dict[int, torch.Tensor]


def _chunk_mac(xin: torch.Tensor, wk: torch.Tensor, lspec, stride: int,
              pad: int) -> torch.Tensor:
    """One MAC chunk's raw int32 (positions, n_ch) popcount difference, in
    ONE kernel launch: ``xin`` (L, Cin) codes or bits for a conv, (1, rows)
    for an FC row slice; ``wk`` (K, Cin, n_ch) or (rows, n_ch) ternary,
    read from the macro's cells."""
    in_bits, in_off = lspec.in_bits, lspec.in_offset
    if not isinstance(lspec, FCSpec):
        if in_bits > 1:
            return ops.bitserial_conv1d(xin, wk, in_bits, in_off,
                                        stride=stride, pad=pad)
        return ops.bnn_conv1d(xin, wk, stride=stride, pad=pad, mode="raw")
    if in_bits == 1:
        return ops.twm_linear(xin, wk, mode="raw")
    # bit-serial FC: the bit planes are the rows of one popcount GEMM
    shifts = torch.arange(in_bits, dtype=torch.int32,
                          device=xin.device)[:, None]
    planes = (xin >> shifts) & 1
    d = (ops.twm_linear(planes, wk, mode="raw") << shifts).sum(
        0, keepdim=True, dtype=torch.int32)
    if in_off:
        d = d - in_off * wk.sum(0, dtype=torch.int32)
    return d


class Executor:
    """Runs a CompiledProgram against fresh macro/SRAM/feature-SRAM state,
    on the device the program lies on."""

    def __init__(
        self,
        prog: CompiledProgram,
        params: EnergyParams | None = None,
        fuse_pool: bool = True,
    ) -> None:
        self.prog = prog
        self.device = ops.resolve_device(None, prog.device)
        self.params = params or EnergyParams()
        self.fuse_pool = fuse_pool

    # -----------------------------------------------------------------------

    def run(self, x) -> ExecutionReport:
        """x: (in_len, in_channels) input codes or bits (numpy or a
        tensor), written to the feature SRAM on the program's device."""
        prog = self.prog
        spec = prog.spec
        dev = self.device
        ledger = EnergyLedger(params=self.params)
        sram = PingPongSRAM(dev)
        layer_cycles: dict[str, int] = {}
        fmaps: dict[int, torch.Tensor] = {}
        stage: dict[int, dict[int, torch.Tensor]] = {}
        raw_acc: dict[int, torch.Tensor] = {}

        in_fmt = "u8" if spec.in_bits > 1 else "bits"
        in_ref = FmapRef(prog.in_addr, spec.in_len, spec.in_channels, in_fmt)
        (sram.write_u8 if in_fmt == "u8" else sram.write_bits)(in_ref, x)

        ifm_addr = ofm_addr = 0
        binding: LayerBinding | None = None
        cur_len, cur_ch = spec.in_len, spec.in_channels
        out: torch.Tensor | None = None

        for pc, word in enumerate(prog.words):
            kind, payload = prog.instr_meta[pc]
            instr = isa.decode(word)

            if isinstance(instr, isa.HaltInstr):
                break

            if isinstance(instr, isa.PtrInstr):
                ifm_addr, ofm_addr = instr.ifm_addr, instr.ofm_addr
                binding = payload
                continue

            if isinstance(instr, isa.WrepInstr):
                chunk: Chunk = payload
                region = prog.rotation_region
                assert region is not None, "WREP without rotation region"
                page = macro.Page(
                    chunk.page_id, region[0], region[1], chunk.rows, chunk.pairs
                )
                prog.cim.claim(page, evict=True)
                prog.cim.write_page(chunk.page_id, prog.wsram.load(chunk.wsram_page))
                bits = chunk.rows * chunk.pairs * 2
                cyc = -(-chunk.rows // macro.WREP_ROWS_PER_CYCLE)
                ledger.charge_wrep(bits_read=bits, cells_written=bits, cycles=cyc)
                layer_cycles["wrep"] = layer_cycles.get("wrep", 0) + cyc
                continue

            assert isinstance(instr, isa.MacInstr) and binding is not None
            lspec = binding.spec
            name = getattr(lspec, "name", f"layer{binding.layer_idx}")

            # ---- standalone pooling (PWB bypass, ltype=1) -------------------
            if instr.ltype == 1:
                ifm = FmapRef(ifm_addr, cur_len, cur_ch, "bits")
                y = sram.read_bits(ifm)
                if instr.k == 0:  # GAP -> 8-bit counts
                    o = pwb.gap_counts(y)[None, :].to(torch.int64)
                    ofm = FmapRef(ofm_addr, 1, cur_ch, "u8")
                    PingPongSRAM.check_layer(ifm, ofm)
                    sram.write_u8(ofm, o)
                    cyc = pwb.gap_cycles(cur_len, cur_ch)
                    wbits, new_len = cur_ch * 8, 1
                else:
                    o = pwb.maxpool_bits(y, instr.k).to(torch.int64)
                    ofm = FmapRef(ofm_addr, o.shape[0], cur_ch, "bits")
                    PingPongSRAM.check_layer(ifm, ofm)
                    sram.write_bits(ofm, o)
                    cyc = pwb.standalone_pool_cycles(cur_len, cur_ch, instr.k)
                    wbits, new_len = o.shape[0] * cur_ch, o.shape[0]
                ledger.charge_cycles(cyc)
                ledger.charge_sram(read_bits=cur_len * cur_ch, write_bits=wbits)
                sram.account_layer(ifm, ofm, cyc)
                layer_cycles[name] = layer_cycles.get(name, 0) + cyc
                fmaps[binding.layer_idx] = o
                out, cur_len = o, new_len
                continue

            # ---- convolution / FC chunk ------------------------------------
            _, chunk = payload
            w_page = prog.cim.read_page(chunk.page_id)
            n_ch = chunk.ch1 - chunk.ch0
            w = w_page[:, :n_ch]

            is_fc = isinstance(lspec, FCSpec)
            k = 1 if is_fc else lspec.k
            stride = 1 if is_fc else lspec.stride
            pad = 0 if is_fc else lspec.pad
            in_bits = lspec.in_bits
            cin = lspec.cin

            ifm = FmapRef(ifm_addr, cur_len, cin, "u8" if in_bits > 1 else "bits")
            xin = sram.read_u8(ifm) if in_bits > 1 else sram.read_bits(ifm)
            if is_fc:
                # row-split chunks see only their slice of the input rows
                xin = xin.reshape(1, -1)[:, chunk.row0_w : chunk.row0_w + chunk.rows]
                wk = w
            else:
                wk = w.reshape(k, cin, n_ch)
            d = _chunk_mac(xin, wk, lspec, stride, pad)

            positions = d.shape[0]
            raw_out = getattr(lspec, "out_raw", False)

            # cycle + energy charges for this chunk
            cyc = positions * in_bits
            if raw_out:
                cyc += positions * READOUT_CYCLES
            phys = chunk.rows * n_ch * positions * in_bits
            logical = chunk.rows * n_ch * positions
            sa = positions * chunk.pairs * in_bits
            ledger.charge_mac_op(logical, phys, sa, cyc)
            ledger.charge_sram(read_bits=cur_len * cin * (in_bits if in_bits > 1 else 1))
            layer_cycles[name] = layer_cycles.get(name, 0) + cyc

            if raw_out:
                acc = raw_acc.setdefault(
                    binding.layer_idx,
                    torch.zeros((positions, lspec.cout), dtype=torch.int64,
                                device=dev),
                )
                acc[:, chunk.ch0 : chunk.ch1] += d
            else:
                # int32 sums against the exported float64 thresholds
                thr, flip = prog.thresholds[binding.layer_idx]
                ge = d >= thr[None, chunk.ch0 : chunk.ch1]
                y = (ge ^ flip[None, chunk.ch0 : chunk.ch1]).to(torch.uint8)
                stage.setdefault(binding.layer_idx, {})[chunk.ch0] = y

            # ---- assemble when the layer's last chunk retires ---------------
            if chunk is binding.chunks[-1]:
                if raw_out:
                    o = raw_acc.pop(binding.layer_idx)
                    ofm = FmapRef(ofm_addr, positions, lspec.cout, "u8")
                    PingPongSRAM.check_layer(ifm, ofm)
                    sram.write_u8(ofm, o.clamp(0, 255))
                    ledger.charge_sram(write_bits=positions * lspec.cout * 8)
                    new_len = positions
                else:
                    sl = stage.pop(binding.layer_idx)
                    o = torch.zeros((positions, lspec.cout), dtype=torch.uint8,
                                    device=dev)
                    for ch in binding.chunks:
                        o[:, ch.ch0 : ch.ch1] = sl[ch.ch0]
                    pool = instr.pool if instr.fuse else 1
                    if pool > 1:
                        if self.fuse_pool:
                            o = pwb.maxpool_bits(o, pool)  # in write-back, free
                        else:
                            # baseline: write conv OFM, separate pool pass
                            ledger.charge_sram(write_bits=positions * lspec.cout)
                            extra = pwb.standalone_pool_cycles(
                                positions, lspec.cout, pool
                            )
                            ledger.charge_cycles(extra)
                            ledger.charge_sram(read_bits=positions * lspec.cout)
                            layer_cycles[name + "+pool"] = extra
                            o = pwb.maxpool_bits(o, pool)
                    ofm = FmapRef(ofm_addr, o.shape[0], lspec.cout, "bits")
                    if self.fuse_pool:
                        PingPongSRAM.check_layer(ifm, ofm)
                    sram.write_bits(ofm, o)
                    ledger.charge_sram(write_bits=o.shape[0] * lspec.cout)
                    new_len = o.shape[0]
                    o = o.to(torch.int64)
                sram.account_layer(ifm, ofm, layer_cycles.get(name, 0))
                fmaps[binding.layer_idx] = o
                out, cur_len, cur_ch = o, new_len, lspec.cout

        assert out is not None, "program produced no output"
        return ExecutionReport(
            output=out,
            ledger=ledger,
            layer_cycles=layer_cycles,
            bank_active_cycles=sram.bank_active_cycles.copy(),
            fmaps=fmaps,
        )
