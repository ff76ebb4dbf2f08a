"""Component-level energy/latency model, calibrated to Table I.

Accounting follows the paper: 1 MAC = 1 OP (350M "MACs per inference",
150.8 "GOPS" = MACs/latency, 885.86 "TOPS/W" = MACs/energy — the arithmetic
only closes under that convention; see DESIGN.md §1).

The model is component-based:
  E = e_mac * active_MACs                (analog macro read, dominant)
    + e_sa * SA_decisions
    + e_sram_r/w * feature-SRAM bits     (ping-pong system)
    + e_wsram_r * weight-SRAM bits + e_cell_w * macro cells (WREP)
    + e_ctrl * cycles                    (controller + instruction fetch)

e_mac is fitted once so the reconstructed KWS model lands on Table I's
0.399 uJ/inference (DESIGN.md §9.4); every other constant is a plausible
28nm figure and all other models/benchmarks reuse the same fitted params.
"""
from __future__ import annotations

import dataclasses

FREQ_HZ = 10e6  # Table I operating point


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    e_mac: float = 0.625161e-15  # J per active MAC (fitted, see calibrate())
    e_sa: float = 2.0e-15        # J per SA decision
    e_sram_r: float = 50e-15     # J per feature-SRAM bit read
    e_sram_w: float = 60e-15     # J per feature-SRAM bit written
    e_wsram_r: float = 50e-15    # J per weight-SRAM bit read (WREP source)
    e_cell_w: float = 100e-15    # J per macro cell programmed (WREP dest)
    e_ctrl: float = 200e-15      # J per cycle (controller, fetch, clocking)


@dataclasses.dataclass
class EnergyLedger:
    """Mutable per-run accumulator the executor charges into."""

    params: EnergyParams = dataclasses.field(default_factory=EnergyParams)
    macs: int = 0        # logical MACs (paper's GOPS/TOPS-W accounting)
    phys_macs: int = 0   # physical macro MAC activations (x bit-serial passes)
    sa_decisions: int = 0
    sram_read_bits: int = 0
    sram_write_bits: int = 0
    wsram_read_bits: int = 0
    cells_written: int = 0
    cycles: int = 0

    def charge_mac_op(
        self, logical_macs: int, phys_macs: int, sa_decisions: int, cycles: int
    ) -> None:
        self.macs += logical_macs
        self.phys_macs += phys_macs
        self.sa_decisions += sa_decisions
        self.cycles += cycles

    def charge_sram(self, read_bits: int = 0, write_bits: int = 0) -> None:
        self.sram_read_bits += read_bits
        self.sram_write_bits += write_bits

    def charge_wrep(self, bits_read: int, cells_written: int, cycles: int) -> None:
        self.wsram_read_bits += bits_read
        self.cells_written += cells_written
        self.cycles += cycles

    def charge_cycles(self, cycles: int) -> None:
        self.cycles += cycles

    # -- results -------------------------------------------------------------

    @property
    def energy_j(self) -> float:
        p = self.params
        return (
            p.e_mac * self.phys_macs
            + p.e_sa * self.sa_decisions
            + p.e_sram_r * self.sram_read_bits
            + p.e_sram_w * self.sram_write_bits
            + p.e_wsram_r * self.wsram_read_bits
            + p.e_cell_w * self.cells_written
            + p.e_ctrl * self.cycles
        )

    @property
    def latency_s(self) -> float:
        return self.cycles / FREQ_HZ

    @property
    def power_w(self) -> float:
        return self.energy_j / self.latency_s if self.cycles else 0.0

    @property
    def gops(self) -> float:
        """Paper convention: MACs / latency, in G/s."""
        return self.macs / self.latency_s / 1e9 if self.cycles else 0.0

    @property
    def tops_per_w(self) -> float:
        """Paper convention: MACs / energy, in T/J."""
        return self.macs / self.energy_j / 1e12 if self.energy_j else 0.0

    def summary(self) -> dict[str, float]:
        return {
            "macs": float(self.macs),
            "cycles": float(self.cycles),
            "latency_us": self.latency_s * 1e6,
            "energy_uj": self.energy_j * 1e6,
            "power_uw": self.power_w * 1e6,
            "gops": self.gops,
            "tops_per_w": self.tops_per_w,
        }


def calibrate_e_mac(ledger: EnergyLedger, target_energy_j: float) -> EnergyParams:
    """Solve e_mac so that this ledger's totals land on the target energy.

    Used once against the reconstructed KWS model (target 0.399 uJ); the
    resulting e_mac is the default in EnergyParams.
    """
    p = ledger.params
    fixed = (
        p.e_sa * ledger.sa_decisions
        + p.e_sram_r * ledger.sram_read_bits
        + p.e_sram_w * ledger.sram_write_bits
        + p.e_wsram_r * ledger.wsram_read_bits
        + p.e_cell_w * ledger.cells_written
        + p.e_ctrl * ledger.cycles
    )
    if ledger.phys_macs == 0:
        raise ValueError("ledger has no MACs to calibrate against")
    e_mac = (target_energy_j - fixed) / ledger.phys_macs
    if e_mac <= 0:
        raise ValueError(f"fixed components {fixed} exceed target {target_energy_j}")
    return dataclasses.replace(p, e_mac=e_mac)
