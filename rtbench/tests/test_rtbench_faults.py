"""The check catches a broken timed path: each run drives the harness on
the CPU (skipping only its look for a card) with the program broken
underneath (``limits.planted``), and ``correct`` must come out false.  The
faults a cell can have: a step that returns its state unchanged (a forward
drop: the first drop's answer again), half of the batch left out (the mean
over the rest), an answer altered where it is produced.  One card a cell:
no exchange between chips to leave out.  And the control, the reference in
bfloat16 in the program's place, fails the limits."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness, limits  # noqa: E402
from rtbench.tests.tiny import run_tiny, tiny_root  # noqa: E402

FWD, CAL = "boxcity131k.fwd.nrx4", "soup234.calib.nrx16"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [FWD, CAL])
def test_sound_program_is_correct(root, cell):
    res = run_tiny(root, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [
    (FWD, "altered"), (FWD, "half"), (FWD, "stale"),
    (CAL, "altered"), (CAL, "half"), (CAL, "still")])
def test_planted_fault_is_not_correct(root, cell, fault):
    with limits.planted(fault):
        res = run_tiny(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [FWD, CAL])
def test_control_fails_the_limits(root, cell):
    lim = harness.load_json(os.path.join(root, "workloads",
                                         f"{cell}.json"))["limits"]
    (got,) = limits.readings(cell, [], [2 ** 32 + 1], "cpu", root=root,
                             calls=2)
    assert any(got[k] > lim[k] for k in lim), got
