"""Ternary Weight Mapping (TWM) semantics and the sense-amplifier model.

Paper Section II-D / Fig. 3.  Under BWM a bitline current is compared with a
reference bitline; under TWM each ternary weight occupies a *pair* of cells
and the SA compares the positive-popcount current with the negative-popcount
current directly.  Two consequences reproduced here:

  1. functional:   out = SA(pop(x & w+) - pop(x & w-) - theta)
  2. reliability:  the worst-case sensing margin doubles (Fig. 3c).  We model
     the SA as comparing (I+ - I-) with additive Gaussian noise of sigma
     cells; BWM's margin is 1 cell-current unit, TWM's is 2.

The popcount MACs are the packed popcount GEMM (B.7, ``ops.twm_linear`` in
raw mode), which launches the CUDA kernel on card tensors and runs its
plain version on CPU tensors (CUDA has no integer ``torch.matmul``).  The
noisy path, which drives the Fig. 3(c) reproduction, draws from an explicit
``torch.Generator`` on the inputs' device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


def _on_device(x) -> torch.Tensor:
    """``x`` as a tensor on the device ``ops.resolve_device`` gives it: a
    tensor keeps its own, anything else goes to the card."""
    return torch.as_tensor(x, device=ops.resolve_device(x))


@dataclasses.dataclass(frozen=True)
class SAModel:
    """Sense-amplifier behavioural model.

    noise_sigma: std-dev of the current-difference sampling noise, in units
    of one cell current (the paper's "sensing variation").  0.0 = ideal
    digital behaviour.
    """

    noise_sigma: float = 0.0

    def decide(self, diff: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Eq. (1): Dout = 1 iff diff >= 0 (with optional sampling noise),
        as ``torch.uint32`` {0, 1}."""
        diff = torch.as_tensor(diff)
        if self.noise_sigma > 0.0:
            if generator is None:
                raise ValueError("noisy SA needs a torch.Generator")
            diff = diff + self.noise_sigma * torch.randn(
                diff.shape, generator=generator, dtype=torch.float32,
                device=diff.device)
        return (diff >= 0).to(torch.int32).view(torch.uint32)


# ---------------------------------------------------------------------------
# Functional TWM MAC (dense form; the kernels implement the packed form)
# ---------------------------------------------------------------------------

def twm_mac(x_bits, w_ternary) -> torch.Tensor:
    """Popcount-difference MAC: x_bits (…, K) in {0,1}, w (K, N) in {-1,0,1}.

    Returns the raw int32 bitline-pair difference (…, N) — the quantity the
    SA senses: ``pop(x & w+) - pop(x & w-)`` on the two packed planes, one
    B.7 launch.
    """
    x = _on_device(x_bits)
    out = ops.twm_linear(x.reshape(-1, x.shape[-1]), w_ternary, mode="raw")
    return out.reshape(*x.shape[:-1], out.shape[-1])


def bwm_mac(x_bits, w_binary, n_ref=None) -> torch.Tensor:
    """Binary-weight-mapping MAC against a reference bitline (Fig. 3a).

    w_binary in {-1,+1} maps to a single cell: +1 programs the cell, -1
    leaves it off; the SA compares against a reference current equal to half
    of the active wordlines.  diff = pop(x & w+) - ref, float32.
    """
    x = _on_device(x_bits)
    wp = (torch.as_tensor(w_binary, device=x.device) > 0).to(torch.int32)
    pop = twm_mac(x, wp)
    active = x.to(torch.int32).sum(-1, keepdim=True)
    ref = active.to(torch.float32) / 2.0 if n_ref is None else n_ref
    return pop.to(torch.float32) - ref


def sensing_margin_twm() -> float:
    """Worst-case margin (cell-current units) for TWM: a ±1 weight flip moves
    the differential current by 2 units (one cell on each bitline)."""
    return 2.0


def sensing_margin_bwm() -> float:
    """Worst-case margin for BWM: 1 unit against the reference."""
    return 1.0


def flip_rate_under_noise(
    generator: torch.Generator,
    x_bits,
    w_ternary,
    sigma: float,
    mapping: str = "twm",
    trials: int = 32,
) -> torch.Tensor:
    """Monte-Carlo SA decision flip-rate vs the ideal decision (Fig. 3c).

    For the BWM arm, zero weights are randomly rounded to ±1 (BWM cannot
    represent 0) — exactly the representational handicap the paper cites.
    ``generator`` lies on the device the MACs run on; returns a 0-dim
    float32 tensor there.
    """
    sa = SAModel(noise_sigma=sigma)
    if mapping == "twm":
        diff = twm_mac(x_bits, w_ternary).to(torch.float32)
        # margin-doubling: differential sensing sees 2 units per LSB
        diff = diff * 2.0
    elif mapping == "bwm":
        w = torch.as_tensor(w_ternary, device=generator.device).to(torch.int32)
        rnd = 2 * torch.randint(0, 2, w.shape, generator=generator,
                                dtype=torch.int32, device=w.device) - 1
        w_b = torch.where(w == 0, rnd, w)
        diff = bwm_mac(x_bits, w_b)
    else:
        raise ValueError(mapping)

    ideal = diff >= 0
    rates = [(sa.decide(diff, generator).view(torch.int32) != 0)
             .ne(ideal).to(torch.float32).mean() for _ in range(trials)]
    return torch.stack(rates).mean()
