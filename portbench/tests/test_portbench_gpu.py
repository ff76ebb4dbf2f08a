"""On the card: each cell's program and its lower-precision control at the
cell's own size, one seed (``control.py`` reads a dozen).  Skips without
a card."""
from __future__ import annotations

import pytest

from portbench import control, harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kws_saturated", "moe_decode_b32"])
def test_program_passes_and_control_fails_at_cell_size(card, workload):
    rec = control.readings(workload, 20261018, 3.0, True)
    assert harness.checks_pass(rec["program"])
    assert not harness.checks_pass(rec["control"])
