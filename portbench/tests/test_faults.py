"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (portbench/faults.py), planted in the program, with
the whole run driven on the CPU at a tiny size (the harness's look for a
card is the command line's, which this skips)."""

import pytest

from portbench import faults, run
from portbench.tests import tiny

CASES = [(w["name"], f) for w in tiny.bench()["workloads"]
         for f in faults.FAULTS if not w["name"].endswith("fit_stream")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    loop = "simulate" if cell.startswith("lego_jelly") else "identify"
    with faults.planted(fault, loop):
        result = run.run_cell(tiny.bench(), cell, 424242, 3.0, False,
                              device="cpu", overrides=tiny.overrides(cell))
    assert result["correct"] is False, result["checks"]
