"""On the card: a cell's path at 16^4 through the harness, its kernels
held to the reference.  Skips without a CUDA card."""

import pytest
import torch

from portbench import harness
from portbench.tests.test_portbench_cells import SEED0, WORKLOADS


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    over = {"sweeps_therm": 20, "dims": (16, 16, 16, 16)}
    rec, checks = harness.run_cell(workload, SEED0, 1.0, False,
                                   overrides=over, log=lambda *a: None)
    assert rec["correct"], checks
