"""The control of ``correct``: the program's own bf16 path in its place
comes out not correct.  On the CPU at a tiny size here; at each cell's own
size on the card (marked ``cuda``)."""

import time

import pytest

from conftest import CELLS, ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(run_tiny, cell):
    sound = run_tiny(cell)
    control = run_tiny(cell, control=True)
    assert sound["correct"] is True
    assert control["correct"] is False
    c = control["checks"]
    assert c["dist_err"]["value"] > c["dist_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card_at_cell_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from cardbench import harness

    res = harness.run(cell, 2300000011, 10.0, False, root=ROOT, t_start=time.perf_counter(),
                      control=True)
    assert res["correct"] is False
