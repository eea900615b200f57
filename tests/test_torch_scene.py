"""PyTorch port vs JAX package: scene flattening and the HRT reader.
Flattening is host numpy on both sides, so the SoA must be bit-equal."""
import dataclasses
import io

import numpy as np
import pytest

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.scene.model import _morton_order as jax_morton
import hermespy_rt_tpu_torch.scene as ts
from hermespy_rt_tpu_torch.scene.model import _morton_order

SCENES = {
    "box": lambda m: m.box_scene(),
    "reflector": lambda m: m.simple_reflector_scene(),
    "soup": lambda m: m.random_soup_scene(300, seed=7),
}


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_scene_bit_equal(name, sort):
    ours = ts.flatten_scene(SCENES[name](ts), sort_triangles=sort,
                             device="cpu")
    ref = js.flatten_scene(SCENES[name](js), sort_triangles=sort)
    assert ours.num_triangles == ref.num_triangles
    assert ours.pad_triangles == ref.pad_triangles
    for f in dataclasses.fields(ref):
        if f.name == "num_triangles":
            continue
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def test_padding_triangles_are_zero():
    soa = ts.flatten_scene(ts.box_scene(), pad_to=128, device="cpu")
    assert soa.pad_triangles == 128
    for f in ("v0", "e1", "e2", "normal", "velocity"):
        assert not getattr(soa, f)[12:].any()
    assert (soa.mesh_id[12:] == -1).all()


def test_morton_order_matches(rng):
    c = rng.normal(size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(_morton_order(c), jax_morton(c))


def test_hrt_reads_jax_written_file(tmp_path):
    meshes = js.random_soup_scene(50, seed=3).meshes + js.box_scene().meshes
    meshes[0].velocity = np.array([1.5, -2.0, 0.25], np.float32)
    meshes[1].material_index = 13
    path = tmp_path / "scene.hrt"
    js.save_hrt(js.HostScene(meshes), str(path))
    got = ts.load_hrt(str(path))
    assert got.num_meshes == 2
    for a, b in zip(got.meshes, meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.velocity, b.velocity)
        assert a.material_index == b.material_index


def test_hrt_rejects_malformed():
    with pytest.raises(ts.HrtFormatError):
        ts.load_hrt(io.BytesIO(b"XYZ\x01\x00\x00\x00"))
    with pytest.raises(ts.HrtFormatError):
        ts.load_hrt(io.BytesIO(b"HRT\x01\x00\x00\x00\x05\x00"))
