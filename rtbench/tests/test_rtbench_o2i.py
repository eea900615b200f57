"""The outdoor-to-indoor cell through the harness on the CPU at the tiny
sizes: a timed run is correct, a traced run reads the device idle under
the program's ``hrt.transmit``, and the control (the transmission
reference in bfloat16) fails the limit."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import pytest  # noqa: E402

from rtbench import harness, limits  # noqa: E402
from rtbench.tests.tiny import run_tiny, tiny_root  # noqa: E402

CELL = "umi_o2i131k.fwd.nrx5"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_is_correct(root, trace):
    res = run_tiny(root, CELL, trace=trace)
    assert res["correct"], res["checks"]
    if trace:
        assert "idle_ms.transmit" in res["metrics"]
    else:
        assert {"queries_per_s", "call_ms_p95", "setup_s"} <= set(
            res["metrics"])


def test_control_fails_the_limit(root):
    lim = harness.load_json(os.path.join(root, "workloads",
                                         f"{CELL}.json"))["limits"]
    (got,) = limits.readings(CELL, [], [2 ** 32 + 1], "cpu", root=root,
                             calls=2)
    assert got["path_mismatch"] > lim["path_mismatch"], got
