"""On the card: each cell's program is correct on a seed the limits were not
set from, and its control (the plain reference with float32 products in
TF32, put in the program's place) is not, at the cell's own sizes and
window.

    python -m pytest portbench/tests/test_portbench_chip.py -q -m cuda

Needs a CUDA device; skips without one.
"""

from __future__ import annotations

import pytest
import torch

from portbench.control import readings
from portbench.harness import bench
from portbench.tests.tiny import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_correct_and_control_not(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = readings(name, seed=990_001, seconds=bench.benchmark()["run_seconds"], control=True)
    assert r["program_correct"], r
    assert not r["control_correct"], r
