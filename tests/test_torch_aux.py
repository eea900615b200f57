"""The port's host-side modules against the JAX package's: ``save_hrt``,
the CLI, the ray figure and viewer, the profiling harness and the native
scene I/O.

Counterparts of ``tests/test_aux.py`` and of
``tests/test_scene_io.py::test_hrt_roundtrip`` / ``::test_hrt_rejects_garbage``:

* ``save_hrt`` writes the JAX package's bytes for the same scene;
* ``convert_main`` then ``trace_main --device cpu`` write the npz keys of
  the JAX CLI, whose values agree within the port's tier (written slots
  alike on more than 99.5%, rtol 1e-4 with a floor of 1e-5 of the largest,
  ``tests/test_torch_tracer.py``);
* the viewer's controls work headless and it draws the JAX viewer's
  segments from the same rays;
* ``time_trace`` counts ``B · ntx · P · (1 + nrx)`` queries a trace;
* the C++ reader, writer, PLY reader and flattening equal the Python ones
  (skipped only where no ``g++`` builds the library).
"""
import _torch_threads  # noqa: F401  (first: the thread share)

import io
import json
import os
import struct

import numpy as np
import pytest

import hermespy_rt_tpu as jhrt
import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.cli import convert_main as jax_convert_main
from hermespy_rt_tpu.cli import trace_main as jax_trace_main
from hermespy_rt_tpu.scene.hrt import save_hrt as jax_save_hrt
from hermespy_rt_tpu_torch import (TracerConfig, box_scene, default_materials,
                                   flatten_scene, load_hrt,
                                   random_soup_scene, simple_reflector_scene,
                                   trace, trace_paths)
from hermespy_rt_tpu_torch.cli import convert_main, trace_main
from hermespy_rt_tpu_torch.scene import HrtFormatError, load_ply, save_hrt
from hermespy_rt_tpu_torch.scene import native
from hermespy_rt_tpu_torch.utils.profiling import (log_metrics,
                                                   profile_trace, time_trace)
from tests.test_scene_io import _write_ply
from tests.utils import ref_scene_path

SCENES = {"box": (box_scene, js.box_scene),
          "soup": (lambda: random_soup_scene(40, seed=3),
                   lambda: js.random_soup_scene(40, seed=3))}


def _bytes(save, scene):
    buf = io.BytesIO()
    save(scene, buf)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_save_hrt_bytes_equal_jax(name, tmp_path):
    ours, theirs = (build() for build in SCENES[name])
    ours.meshes[0].velocity = np.array([1.0, -2.0, 0.5], np.float32)
    theirs.meshes[0].velocity = np.array([1.0, -2.0, 0.5], np.float32)
    data = _bytes(save_hrt, ours)
    assert data == _bytes(jax_save_hrt, theirs)
    path = str(tmp_path / "s.hrt")           # and through a path
    save_hrt(ours, path)
    with open(path, "rb") as f:
        assert f.read() == data


def test_hrt_roundtrip(tmp_path):
    scene = box_scene()
    scene.meshes[0].velocity = np.array([1.0, -2.0, 0.5], np.float32)
    p = str(tmp_path / "box.hrt")
    save_hrt(scene, p)
    loaded = load_hrt(p)
    assert loaded.num_meshes == 1
    m0, m1 = scene.meshes[0], loaded.meshes[0]
    np.testing.assert_array_equal(m0.vertices, m1.vertices)
    np.testing.assert_array_equal(m0.indices, m1.indices)
    assert m1.material_index == m0.material_index
    np.testing.assert_array_equal(m0.velocity, m1.velocity)


def test_hrt_rejects_garbage():
    for data in (b"NOT A SCENE", b"HRT" + struct.pack("<I", 0),
                 b"HRT" + struct.pack("<I", 100000)):
        with pytest.raises(HrtFormatError):
            load_hrt(io.BytesIO(data))


def _close(ref, ours, key):
    """The port's tier of tests/test_torch_tracer.py."""
    assert ref.shape == ours.shape and ref.dtype == ours.dtype, key
    w_r, w_o = np.abs(ref) > 0, np.abs(ours) > 0
    if ref.ndim == 4:
        w_r, w_o = w_r.any(-1), w_o.any(-1)
    assert (w_r == w_o).mean() > 0.995, key
    m = w_r & w_o
    if m.any():
        np.testing.assert_allclose(ours[m], ref[m], rtol=1e-4,
                                   atol=np.abs(ref[m]).max() * 1e-5,
                                   err_msg=key)


def test_cli_convert_and_trace_match_jax(tmp_path, capsys):
    out = str(tmp_path / "box_out.hrt")
    assert convert_main([str(tmp_path / "box.xml"), "-o", out]) == 0
    assert json.loads(capsys.readouterr().out)["num_triangles"] == 12
    jax_out = str(tmp_path / "box_jax.hrt")
    assert jax_convert_main([str(tmp_path / "box.xml"), "-o", jax_out]) == 0
    capsys.readouterr()
    with open(out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()

    args = [out, "--tx=-2,-1,2.5", "--rx", "1,2,1.5", "--rx", "0,0,3",
            "--rx-vel", "1,0,0", "--rx-vel", "0,0,0", "-p", "128", "-b", "2"]
    npz = str(tmp_path / "paths.npz")
    metrics = str(tmp_path / "m.jsonl")
    assert trace_main(args + ["--device", "cpu", "--backend", "torch",
                              "-o", npz, "--metrics", metrics]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["scatter_nonzero"] > 0 and summary["queries_per_s"] > 0
    record = json.loads(open(metrics).read().splitlines()[-1])
    assert record["queries"] == 2 * 1 * 128 * (1 + 2)
    jax_npz = str(tmp_path / "paths_jax.npz")
    assert jax_trace_main(args + ["--backend", "jnp", "-o", jax_npz]) == 0
    ours, ref = np.load(npz), np.load(jax_npz)
    assert sorted(ours.files) == sorted(ref.files)
    assert ours["scatter_a_te"].shape == (2, 1, 256)
    for k in ref.files:
        _close(ref[k], ours[k], k)


def _box_rays(keep=True):
    res = trace(box_scene(), [[1.0, 2.0, 1.5]], [[-2.0, -1.0, 2.5]],
                config=TracerConfig(num_paths=64, num_bounces=3,
                                    keep_rays=keep), device="cpu")
    return res.rays_scatter


def test_viz_renders_png(tmp_path):
    from hermespy_rt_tpu_torch.viz import save_rays_figure
    out = str(tmp_path / "rays.png")
    assert save_rays_figure(box_scene(), _box_rays(), out) == out
    assert os.path.getsize(out) > 10_000


def _segments(viewer):
    return [np.stack(line.get_data_3d()) for line in viewer._ray_artists]


def test_interactive_viewer_controls_match_jax():
    """x / z step the bounce slot (clamped), d pans, e rolls; at every slot
    the drawn segments are the JAX viewer's on the same rays."""
    from hermespy_rt_tpu.tracer import RaysInfo as JaxRays
    from hermespy_rt_tpu.viz import vizrays as jax_vizrays
    from hermespy_rt_tpu_torch.viz import vizrays

    rays = _box_rays()
    jrays = JaxRays(*(getattr(rays, f).detach().numpy() for f in
                      ("origins", "directions", "active")))
    viewer = vizrays(box_scene(), rays, show=False, max_rays=32)
    ref = jax_vizrays(js.box_scene(), jrays, show=False, max_rays=32)

    class E:
        def __init__(self, key):
            self.key = key

    assert viewer.bounce == 0 and len(viewer._ray_artists) > 0
    for key in ("", "x", "x", "x", "x", "z"):
        if key:
            viewer.on_key(E(key))
            ref.on_key(E(key))
        assert viewer.bounce == ref.bounce
        ours, theirs = _segments(viewer), _segments(ref)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    assert viewer.bounce == viewer.num_slots - 2
    xlim0 = viewer.ax.get_xlim()
    viewer.on_key(E("d"))
    assert viewer.ax.get_xlim() != xlim0
    roll0 = getattr(viewer.ax, "roll", 0.0)
    viewer.on_key(E("e"))
    assert getattr(viewer.ax, "roll", 0.0) != roll0
    import matplotlib.pyplot as plt
    plt.close("all")


def test_profiling_harness(tmp_path):
    cfg = TracerConfig(num_paths=64, num_bounces=1, keep_rays=False)
    tris = flatten_scene(simple_reflector_scene(), device="cpu")
    mats = default_materials("cpu")

    def run(_):
        return trace_paths(tris, mats, [[0, 0, 0.15]], [[0, 0, 0.151]],
                           [[0.0] * 3], [[0.0] * 3], 3.0, cfg).scatter.tau

    stats = time_trace(run, 0, num_paths=64, num_bounces=1, iters=2)
    assert stats.queries == 1 * 64 * 2 * 1
    assert stats.queries_per_s > 0
    path = str(tmp_path / "m.jsonl")
    rec = log_metrics(stats, extra={"scene": "reflector"}, path=path)
    assert rec["scene"] == "reflector"
    assert json.loads(open(path).read()) == rec
    with profile_trace(str(tmp_path / "prof")):
        run(0)
    (trace_file,) = os.listdir(tmp_path / "prof")
    assert json.load(open(tmp_path / "prof" / trace_file))


@pytest.fixture()
def native_lib():
    """Skips only where no C++ compiler is on ``PATH`` (decided here, not
    while the module is imported); a library that fails to build or load
    fails the test."""
    if native.compiler() is None:
        pytest.skip("no g++ to build csrc/hrt_io.cpp")
    native._get_lib()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_native_io_matches_python(native_lib, name, tmp_path):
    scene = SCENES[name][0]()
    scene.meshes[0].velocity = np.array([0.5, 0.0, -1.0], np.float32)
    path = str(tmp_path / "s.hrt")
    native.save_hrt_native(scene, path)
    assert open(path, "rb").read() == _bytes(save_hrt, scene)
    back = native.load_hrt_native(path)
    py = load_hrt(path)
    assert back.num_meshes == py.num_meshes
    for a, b in zip(back.meshes, py.meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.material_index == b.material_index
        np.testing.assert_array_equal(a.velocity, b.velocity)
    v0, e1, e2, n, vel, mat, mid = native.flatten_arrays_native(scene, 128)
    soa = flatten_scene(scene, pad_to=128, device="cpu")
    for x, y in ((v0, soa.v0), (e1, soa.e1), (e2, soa.e2), (vel,
                                                            soa.velocity)):
        np.testing.assert_array_equal(x, y.numpy())
    np.testing.assert_allclose(n, soa.normal.numpy(), atol=2e-7)
    np.testing.assert_array_equal(mat, soa.material.numpy())
    np.testing.assert_array_equal(mid, soa.mesh_id.numpy())


def test_native_ply_reader(native_lib, tmp_path):
    ply = str(tmp_path / "tri.ply")
    _write_ply(ply, [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]],
               [[0, 1, 2], [1, 3, 2]])
    mesh = native.load_ply_native(ply, material_index=4,
                                  velocity=(1.0, 2.0, 3.0))
    py = load_ply(ply)
    np.testing.assert_array_equal(mesh.vertices, py.vertices)
    np.testing.assert_array_equal(mesh.indices, py.indices)
    assert mesh.material_index == 4
    np.testing.assert_array_equal(mesh.velocity, [1.0, 2.0, 3.0])
    with pytest.raises(native.NativeIOError):
        native.load_ply_native(str(tmp_path / "missing.ply"))


def test_native_reads_reference_scene(native_lib, tmp_path):
    path = ref_scene_path("2cars.hrt")
    s_native, s_py = native.load_hrt_native(path), load_hrt(path)
    assert s_native.num_meshes == s_py.num_meshes
    for a, b in zip(s_native.meshes, s_py.meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)


def test_reference_scene_traces_as_jax():
    """The CLI's scene path on a reference scene: the port's trace of
    ``2cars.hrt`` against the JAX package's."""
    path = ref_scene_path("2cars.hrt")
    cfg = dict(num_paths=256, num_bounces=2)
    ours = trace(path, [[10.0, 3.0, 1.5]], [[0.0, 0.0, 5.0]],
                 config=TracerConfig(**cfg), device="cpu")
    ref = jhrt.trace(path, [[10.0, 3.0, 1.5]], [[0.0, 0.0, 5.0]],
                     config=jhrt.TracerConfig(backend="jnp", **cfg))
    for f in ("a_te", "tau"):
        _close(np.asarray(getattr(ref.scatter, f)),
               getattr(ours.scatter, f).numpy(), f)
