"""PyTorch port vs JAX package: the Sionna / Mitsuba importer and the
procedural config-5 city.

The port's ``make_city`` writes the same bytes as
``benchmarks/config5_scene.py::make_city`` (the test imports that script;
the port may not), and the port's ``load_scene`` reads that city, a CSV
override and XML that is not well formed exactly as the JAX ``load_scene``
does: vertices, faces, material ids, velocities, names, the baked
``to_world`` lift, and the flattened, Morton-sorted triangles."""
import _torch_threads  # noqa: F401  (first: the thread share)

import os
import shutil
import sys

import numpy as np
import pytest

import hermespy_rt_tpu.scene as js
import hermespy_rt_tpu_torch as hrt
from hermespy_rt_tpu.scene import sionna as jax_sionna
from hermespy_rt_tpu_torch.scene import sionna as port_sionna

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from config5_scene import make_city as bench_make_city  # noqa: E402

SMALL = dict(n_buildings=4, sub=2, ground_sub=4)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _assert_same_scene(port, ref):
    assert len(port.meshes) == len(ref.meshes)
    for a, b in zip(port.meshes, ref.meshes):
        assert a.name == b.name
        assert a.material_index == b.material_index
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.velocity, b.velocity)
        assert a.vertices.dtype == b.vertices.dtype == np.float32


@pytest.mark.parametrize("kw", [SMALL, dict(n_buildings=3, sub=3,
                                            ground_sub=5, seed=7,
                                            zlift=0.25)])
def test_make_city_writes_the_same_bytes(tmp_path, kw):
    xml_p = hrt.scene.make_city(str(tmp_path / "port"), **kw)
    xml_b = bench_make_city(str(tmp_path / "bench"), **kw)
    assert os.path.basename(xml_p) == os.path.basename(xml_b) == "city.xml"
    files = _files(tmp_path / "port")
    assert sorted(files) == ["city.xml",
                             os.path.join("meshes", "buildings.ply"),
                             os.path.join("meshes", "ground.ply")]
    assert files == _files(tmp_path / "bench")


def test_city_loads_as_in_jax(tmp_path):
    xml = hrt.scene.make_city(str(tmp_path), **SMALL)
    port, ref = hrt.load_scene(xml), js.load_scene(xml)
    _assert_same_scene(port, ref)
    assert port.num_triangles == 4 * 12 * 4 + 32
    assert {m.material_index for m in port.meshes} == {1, 15}
    bld = [m for m in port.meshes if m.name == "buildings"][0]
    # the to_world lift is baked: every building-bottom vertex sits at
    # float32(0.05), the f64 sum cast to f32
    assert float(bld.vertices[:, 2].min()) == pytest.approx(0.05)
    assert bld.vertices[:, 2].min() == np.float32(np.float64(0.0) + 0.05)
    soa_p = hrt.flatten_scene(port, sort_triangles=True, device="cpu")
    soa_j = js.flatten_scene(ref, sort_triangles=True)
    for f in ("v0", "e1", "e2", "normal", "velocity", "material"):
        np.testing.assert_array_equal(getattr(soa_p, f).numpy(),
                                      np.asarray(getattr(soa_j, f)), f)


def test_csv_override_and_ply_and_builtin_names(tmp_path):
    xml = hrt.scene.make_city(str(tmp_path), **SMALL)
    with open(os.path.join(tmp_path, "city.csv"), "w") as f:
        f.write("name,material_index,velocity_x,velocity_y,velocity_z\n"
                "buildings,13,1.5,-2.0,0.25\n\n")
    port, ref = hrt.load_scene(xml), js.load_scene(xml)
    _assert_same_scene(port, ref)
    bld = [m for m in port.meshes if m.name == "buildings"][0]
    assert bld.material_index == 13
    np.testing.assert_array_equal(bld.velocity, [1.5, -2.0, 0.25])
    ply = os.path.join(tmp_path, "meshes", "ground.ply")
    _assert_same_scene(hrt.load_scene(ply), js.load_scene(ply))
    for name in ("box.xml", "simple_reflector.xml"):
        _assert_same_scene(hrt.load_scene(os.path.join(tmp_path, name)),
                           js.load_scene(os.path.join(tmp_path, name)))
    with open(os.path.join(tmp_path, "bad.csv"), "w") as f:
        f.write("name,material\n")
    shutil.copy(xml, os.path.join(tmp_path, "bad.xml"))
    with pytest.raises(ValueError):
        hrt.load_scene(os.path.join(tmp_path, "bad.xml"))


def test_malformed_xml_falls_back_to_the_regex_scan(tmp_path):
    hrt.scene.make_city(str(tmp_path), **SMALL)
    # an unclosed <scene> and a bare '&': not well-formed XML; the regex
    # scan ignores transforms, so the lift is not applied
    text = """<scene version="2.1.0"> & broken
  <shape type="ply" name="ground">
    <string name="filename" value="meshes/ground.ply"/>
    <ref id="mat-itu_wet_ground" name="bsdf"/>
  </shape>
  <shape type="ply" name="buildings">
    <string name="filename" value="meshes/buildings.ply"/>
    <ref id="mat-itu_metal" name="bsdf"/>
    <transform name="to_world"><translate z="9"/></transform>
  </shape>
"""
    path = os.path.join(tmp_path, "broken.xml")
    with open(path, "w") as f:
        f.write(text)
    port, ref = hrt.load_scene(path), js.load_scene(path)
    _assert_same_scene(port, ref)
    assert [m.material_index for m in port.meshes] == [16, 13]
    bld = port.meshes[1]
    assert float(bld.vertices[:, 2].min()) == 0.0


def test_transform_matrix_matches_jax():
    import xml.etree.ElementTree as ET
    el = ET.fromstring(
        '<transform name="to_world"><scale value="2 0.5 3"/>'
        '<rotate x="0.3" y="-1" z="0.5" angle="37"/>'
        '<translate x="1" y="-2" z="0.05"/>'
        '<matrix value="1 0 0 0.5 0 0 -1 0 0 1 0 2 0 0 0 1"/></transform>')
    m_p = port_sionna._transform_matrix(el)
    np.testing.assert_array_equal(m_p, jax_sionna._transform_matrix(el))
    assert m_p.dtype == np.float64


def test_unsupported_extension_raises(tmp_path):
    with pytest.raises(ValueError):
        hrt.load_scene(str(tmp_path / "scene.obj"))
