"""PSCNN core: the paper's contribution as composable subsystems, the
chip twin of the reference's ``repro/core`` in PyTorch.

quant     — straight-through quantizers, bit-packing, ternary planes
twm       — ternary weight mapping + sense-amplifier model (Fig. 3)
macro     — 1Mb CIM macro simulator (1024x1024, 128 SAs)
isa       — 32-bit MAC/WREP/PTR/HALT instruction set (Fig. 2)
cnn_spec  — declarative binary 1-D CNN model description
compiler  — spec -> placement + weight SRAM plan + instruction stream
executor  — controller: runs programs against simulated hardware state,
            each MAC chunk one launch of a hand-written kernel
pwb       — pooling write-back unit (Fig. 6)
pingpong  — flexible 4x64Kb ping-pong feature SRAM (Fig. 5)
energy    — cycle/energy model calibrated to Table I

The simulated state (cell planes, weight SRAM, feature SRAM words) lives
on one device, the card unless ``device="cpu"`` is asked for.
"""
from repro_torch.core import (
    cnn_spec,
    energy,
    isa,
    macro,
    pingpong,
    pwb,
    quant,
    twm,
)
from repro_torch.core.compiler import CompiledProgram, compile_model
from repro_torch.core.executor import ExecutionReport, Executor

__all__ = [
    "quant", "twm", "macro", "isa", "cnn_spec", "pwb", "pingpong", "energy",
    "compile_model", "CompiledProgram", "Executor", "ExecutionReport",
]
