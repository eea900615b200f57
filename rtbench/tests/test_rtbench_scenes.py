"""The frozen scene generators: triangle counts, determinism, and the
city as the program's own Sionna reader reads it back."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness  # noqa: E402
from rtbench.tests.tiny import RTBENCH  # noqa: E402

CANYON = harness.load_json(os.path.join(RTBENCH, "configs",
                                        "soup234.json"))["scene"]
CITY = harness.load_json(os.path.join(RTBENCH, "configs",
                                      "boxcity131k.json"))["scene"]


def gen(name):
    return harness.load_module(os.path.join(RTBENCH, "scenes", f"{name}.py"),
                               f"rtbench_scene_{name}")


def test_soup_has_234_triangles_and_repeats(tmp_path):
    a = gen("soup").generate(CANYON, str(tmp_path))
    b = gen("soup").generate(CANYON, str(tmp_path))
    (va, fa, ma), = a["meshes"]
    (vb, fb, _), = b["meshes"]
    assert fa.shape == (234, 3) and va.shape == (702, 3) and ma == 1
    assert va.tobytes() == vb.tobytes() and a["file"] is None


def test_city_has_131072_triangles_and_repeats(tmp_path):
    a = gen("city").generate(CITY, str(tmp_path / "a"))
    b = gen("city").generate(CITY, str(tmp_path / "b"))
    assert sum(len(f) for _, f, _ in a["meshes"]) == 131072
    assert len(a["footprints"]) == 160
    for name in ("city.xml", "meshes/ground.ply", "meshes/buildings.ply"):
        with open(tmp_path / "a" / name, "rb") as x, \
                open(tmp_path / "b" / name, "rb") as y:
            assert x.read() == y.read()


@pytest.mark.parametrize("n_buildings", [16, 160])
def test_city_meshes_are_what_the_program_reads(tmp_path, n_buildings):
    from hermespy_rt_tpu_torch.scene import load_scene
    params = dict(CITY, n_buildings=n_buildings,
                  sub=2 if n_buildings == 16 else CITY["sub"])
    out = gen("city").generate(params, str(tmp_path))
    host = load_scene(out["file"])
    assert len(host.meshes) == len(out["meshes"])
    for (v, f, m), mesh in zip(out["meshes"], host.meshes):
        assert np.array_equal(v, mesh.vertices)
        assert np.array_equal(f, mesh.indices)
        assert m == mesh.material_index
