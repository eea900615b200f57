"""Seeded traffic: the same seed gives the same inputs, bit for bit; other
seeds other inputs; the city's RX stay outside every footprint."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness, traffic  # noqa: E402
from rtbench.tests.tiny import RTBENCH  # noqa: E402

CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(RTBENCH, "workloads")))


def params(cell):
    return harness.load_json(os.path.join(RTBENCH, "workloads",
                                          f"{cell}.json"))["traffic_params"]


FEET = np.array([[-10.0, -10.0, 10.0, 10.0], [50.0, 50.0, 90.0, 70.0]])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345, 2 ** 40 + 3])
def test_same_seed_same_inputs(cell, seed):
    a = traffic.make(params(cell), seed, FEET)
    b = traffic.make(params(cell), seed, FEET)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
    c = traffic.make(params(cell), seed + 1, FEET)
    assert any(np.asarray(c[k]).tobytes() != np.asarray(a[k]).tobytes()
               for k in a)


@pytest.mark.parametrize("cell", CELLS)
def test_inputs_have_the_cells_shapes(cell):
    p = params(cell)
    out = traffic.make(p, 7, FEET)
    n = p["rx"]["count"]
    pool = p.get("pool", 4096) if p.get("per_call") else 1
    assert out["rx"].shape == (pool, n, 3) and out["rx"].dtype == np.float32
    if "targets_db" in p:
        lo, hi = p["targets_db"]
        assert out["targets_db"].shape == (n,)
        assert ((out["targets_db"] >= lo) & (out["targets_db"] <= hi)).all()


def test_rx_avoid_footprints():
    p = dict(kind="box", lo=[-100.0, -100.0, 1.5], hi=[100.0, 100.0, 1.5],
             count=4, avoid_footprints=True, margin=1.0)
    pos = traffic.draw_rx(p, 500, traffic.rng(3, "rx"), FEET).reshape(-1, 3)
    for x0, y0, x1, y1 in FEET:
        inside = ((pos[:, 0] >= x0 - 1) & (pos[:, 0] <= x1 + 1)
                  & (pos[:, 1] >= y0 - 1) & (pos[:, 1] <= y1 + 1))
        assert not inside.any()
    assert (pos[:, 2] == 1.5).all()


def test_fixed_points_are_the_same_set_in_every_run():
    p = dict(rx=dict(kind="box", lo=[-100.0, -100.0, 1.5],
                     hi=[100.0, 100.0, 1.5], count=6), rx_seed=4,
             targets_db=[-1.0, 1.0])
    sets = [traffic.make(p, s, FEET)["rx"][0] for s in (1, 2, 3)]
    keys = [sorted(map(tuple, x)) for x in sets]
    assert keys[0] == keys[1] == keys[2]
    assert any(not np.array_equal(sets[0], x) for x in sets[1:])
