"""On the card: the check passes the program as each cell runs it and
fails its lower-precision control, the program's own int8 serving path,
at a batch a test run holds (64 boards; the cells' own sizes are measured
by portbench/control.py, PERF.md gives the readings).

    python -m pytest -o addopts= -p no:cacheprovider -m cuda portbench/tests -q
"""
from __future__ import annotations

import copy

import pytest
import torch

from portbench.control import readings
from portbench.harness.cells import cell_names, load_cell

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def small(name):
    cell = copy.deepcopy(load_cell(name))
    cell["traffic"]["batch"] = 64
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_program_passes_and_int8_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cell = small(name)
    sound = readings(name, SEEDS[:2], 3.0, None, dev, cell=cell, check={"boards": 32})
    assert all(ok for _, ok, _, _ in sound), sound
    control = readings(name, SEEDS, 3.0, "serveq", dev, cell=cell, check={"boards": 32})
    assert not any(ok for _, ok, _, _ in control), control
