"""A run with the timed path broken underneath comes out not correct:
the harness's drive of a cell at a tiny size on the CPU (the look for a
card skipped), with each fault the cell can have planted in the program,
held to the cell's own limits."""

import pytest

from portbench.lib import bench
from portbench.tests.tiny_cell import make_run

FAULTS = [("train", "state_unchanged"), ("train", "half_batch"),
          ("single", "answer_altered"), ("lockstep", "answer_altered"),
          ("single", "fast_unstepped"), ("lockstep", "fast_unstepped")]


@pytest.mark.parametrize("kind,fault", FAULTS)
def test_fault_is_not_correct(kind, fault):
    run = make_run(kind, seed=7, fault=fault)
    result, numbers = bench.execute(run)
    assert not result["correct"], numbers
    assert any(v > lim for _, v, lim in numbers)
