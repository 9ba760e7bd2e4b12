"""On the card, at each cell's own size: the control (the reference with
TF32 matrix products in the program's place) comes out not correct on
three seeds, and the program correct.  A window of one subcycle (`--seconds
0`) and the closing one; about 4 minutes in all.  Skips without a CUDA device.  Run on the card with
`python -m pytest -m gpu benchmark/tests`.

The cell's size matters: cut to ne = 8 at NE120's 75-s step the Courant
number falls 15-fold and the control's first_l2 reads 3.0e-5, at the
limit; at the cell's size it reads 4.3e-4."""

import time

import pytest
import torch

from benchmark import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ne120_perf.q35", "ne30_perf.q35"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_is_not_correct_and_program_is(card, workload, seed):
    ctl = harness.run_cell(workload, seed, 0, 0, time.perf_counter(),
                           device=card, control="tf32")
    assert not ctl["correct"], ctl["check"]
    prog = harness.run_cell(workload, seed, 0, 0, time.perf_counter(),
                            device=card)
    assert prog["correct"], prog["check"]
