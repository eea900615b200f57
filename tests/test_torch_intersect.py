"""PyTorch port vs JAX package: the nearest-hit query.

``intersect_torch`` (the plain twin of the CUDA kernel) is held against the
jnp golden ``intersect_jnp`` and against the Pallas kernel run in interpret
mode, on the same numpy inputs.  Every ray whose hit index differs must be a
provable epsilon-edge or tie case in float64 (``assert_flips_explained``),
and ``t`` must agree to rtol 2e-5 where the index agrees, as
``tests/test_pallas.py`` holds the Pallas kernel.  Dead rays (``live``
False) are left out of the comparison: their result is unspecified in the JAX
package and a miss in the port.  The kernel itself is tested on the card by
``tests/test_torch_cuda.py``."""
import _torch_threads  # noqa: F401  (first: the thread share)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.ops.intersect import intersect_jnp
from hermespy_rt_tpu.ops.intersect import recompute_hit_t as jax_recompute
from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect
from hermespy_rt_tpu_torch import compute_paths
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.convert import soa_from_jax
from hermespy_rt_tpu_torch.ops.intersect import (intersect_torch,
                                                 recompute_hit_t)
from hermespy_rt_tpu_torch.ops.intersect_cuda import (NearestHitKernel,
                                                      brute_block_rays)
from hermespy_rt_tpu_torch.ops.walk import triangle_records
from hermespy_rt_tpu_torch.scene import random_soup_scene
from tests.utils import assert_flips_explained


def _rays(rng, R, lo, hi, z=None):
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    if z is not None:
        o[:, 2] = rng.uniform(*z, R)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _scene(name):
    if name == "soup":
        return js.flatten_scene(js.random_soup_scene(300, seed=7), pad_to=128)
    return js.flatten_scene(js.box_scene(), pad_to=128)


def _options(rng, opt, R, T):
    kw = {}
    if opt in ("exclude", "all"):
        kw["exclude"] = rng.integers(-1, T, R).astype(np.int32)
    if opt == "t_max":
        kw["t_max"] = 20.0
    if opt in ("t_max_rays", "all"):
        kw["t_max"] = rng.uniform(0, 60, R).astype(np.float32)
    if opt in ("live", "all"):
        kw["live"] = rng.uniform(size=R) < 0.6
    return kw


def _compare(soa, o, d, t1, i1, t2, i2, live=None, label=""):
    t1, i1, t2, i2 = map(np.asarray, (t1, i1, t2, i2))
    if live is not None:
        o, d = o[live], d[live]
        t1, i1, t2, i2 = t1[live], i1[live], t2[live], i2[live]
    assert_flips_explained(soa, o, d, t1, i1, t2, i2, label=label)
    m = (i1 == i2) & (i1 >= 0)
    np.testing.assert_allclose(t2[m], t1[m], rtol=2e-5)


def _torch_kw(kw):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("opt", ["plain", "exclude", "t_max", "t_max_rays",
                                 "live", "all"])
@pytest.mark.parametrize("name", ["soup", "box"])
def test_twin_matches_pallas_kernel(rng, name, opt):
    soa = _scene(name)
    R = 1024
    o, d = (_rays(rng, R, -60, 60) if name == "soup"
            else _rays(rng, R, -4, 4, z=(0.5, 4.5)))
    kw = _options(rng, opt, R, soa.pad_triangles)
    fn = make_pallas_intersect(soa, interpret=True)
    t_p, i_p = fn(jnp.asarray(o), jnp.asarray(d),
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    t_t, i_t = intersect_torch(torch.as_tensor(o), torch.as_tensor(d),
                               soa_from_jax(vars(soa)), chunk_size=256,
                               **_torch_kw(kw))
    assert i_t.dtype == torch.int32 and t_t.dtype == torch.float32
    live = kw.get("live")
    _compare(soa, o, d, t_p, i_p, t_t.numpy(), i_t.numpy(), live=live,
             label=f"twin-vs-pallas/{name}/{opt}")
    if live is not None:   # dead rays report a miss in the port
        assert (i_t.numpy()[~live] == -1).all()
        assert np.isinf(t_t.numpy()[~live]).all()


@pytest.mark.parametrize("opt", ["plain", "exclude", "t_max_rays"])
@pytest.mark.parametrize("name", ["soup", "box"])
def test_twin_matches_jnp_golden(rng, name, opt):
    soa = _scene(name)
    R = 2048
    o, d = (_rays(rng, R, -60, 60) if name == "soup"
            else _rays(rng, R, -4, 4, z=(0.5, 4.5)))
    kw = _options(rng, opt, R, soa.pad_triangles)
    t_j, i_j = intersect_jnp(jnp.asarray(o), jnp.asarray(d), soa,
                             exclude=(jnp.asarray(kw["exclude"])
                                      if "exclude" in kw else None))
    t_j, i_j = np.asarray(t_j), np.asarray(i_j)
    if "t_max" in kw:   # the JAX tracer applies t_max after the query
        within = t_j <= kw["t_max"]
        t_j, i_j = np.where(within, t_j, np.inf), np.where(within, i_j, -1)
    t_t, i_t = intersect_torch(torch.as_tensor(o), torch.as_tensor(d),
                               soa_from_jax(vars(soa)), chunk_size=500,
                               **_torch_kw(kw))
    _compare(soa, o, d, t_j, i_j, t_t.numpy(), i_t.numpy(),
             label=f"twin-vs-jnp/{name}/{opt}")


def test_twin_ragged_and_many_tiles(rng):
    # R not a multiple of any chunk; 1000 triangles span several Pallas tiles
    soa = js.flatten_scene(js.random_soup_scene(1000, seed=11), pad_to=128)
    o, d = _rays(rng, 777, -60, 60)
    fn = make_pallas_intersect(soa, block_tris=128, interpret=True)
    t_p, i_p = fn(jnp.asarray(o), jnp.asarray(d))
    t_t, i_t = intersect_torch(torch.as_tensor(o), torch.as_tensor(d),
                               soa_from_jax(vars(soa)), chunk_size=100)
    assert t_t.shape == (777,)
    _compare(soa, o, d, t_p, i_p, t_t.numpy(), i_t.numpy(),
             label="twin-vs-pallas/multi-tile")


def _tie_scene(n=200, seed=9):
    """``n`` random triangles followed by their exact copies (``n`` rows
    later), padded to 512: a hit on one ties with the other across the
    kernels' tile edges of 64 and, for ``k >= 256 - n``, of 256."""
    m = js.random_soup_scene(n, seed=seed, extent=40.0,
                             tri_size=4.0).meshes[0]
    idx = np.concatenate([m.indices, m.indices])
    return js.flatten_scene(js.HostScene([js.HostMesh(
        m.vertices, idx, material_index=m.material_index)]), pad_to=512)


def _live_pattern(rng, pattern, R):
    """The scan kernels' live patterns: one live ray in every block of 256,
    every 7th ray, 17% scattered at random, or 17% as runs of live rays in
    bands of 2048."""
    r = np.arange(R)
    if pattern == "one_a_block":
        return r % 256 == 37
    if pattern == "every_7th":
        return r % 7 == 0
    if pattern == "0.17 banded":
        return r % 2048 < 0.17 * 2048
    return rng.uniform(size=R) < 0.17


def _aimed_query(rng, soa, R, pattern):
    """R rays from the scene's box, half aimed at a random triangle's
    centroid; exclude a random triangle, or for a quarter of the aimed rays
    their target; a per-ray t_max and the live pattern."""
    n = int(soa.num_triangles)
    v0, e1, e2 = (np.asarray(getattr(soa, f))[:n] for f in ("v0", "e1", "e2"))
    cen = v0 + (e1 + e2) / np.float32(3.0)
    o = rng.uniform(-50, 50, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    aim = rng.uniform(size=R) < 0.5
    target = rng.integers(0, n, int(aim.sum()))
    d[aim] = cen[target] - o[aim]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ex = rng.integers(-1, soa.pad_triangles, R).astype(np.int32)
    ex[np.flatnonzero(aim)[1::4]] = target[1::4]
    return o, d, dict(exclude=ex,
                      t_max=rng.uniform(0, 120, R).astype(np.float32),
                      live=_live_pattern(rng, pattern, R))


def _compare_grazing(soa, o, d, t1, i1, t2, i2, label):
    """:func:`_compare`'s decisions (every flip an f64 edge or tie case),
    and ``t`` within rtol 2e-5 where the indices agree, widened as
    0.01 / |cos| below |cos| = 0.01, cos the angle between the ray and its
    triangle's plane normal: at grazing incidence one f32 rounding of det
    or of e2 . q moves t by ~eps / |cos| (a hit at |cos| = 7e-4 of this
    data gives t 3e-5 apart from the f64 value in the twin, the golden and
    the Pallas kernel alike)."""
    t1, i1, t2, i2 = map(np.asarray, (t1, i1, t2, i2))
    assert_flips_explained(soa, o, d, t1, i1, t2, i2, label=label)
    m = (i1 == i2) & (i1 >= 0)
    e1, e2 = (np.asarray(getattr(soa, f))[i1[m]] for f in ("e1", "e2"))
    n = np.cross(e1, e2)
    cos = np.abs((d[m] * n).sum(1)) / np.linalg.norm(n, axis=1)
    rtol = 2e-5 * np.maximum(1.0, 0.01 / cos)
    assert (np.abs(t2[m] - t1[m]) <= rtol * np.abs(t1[m])).all(), label


@pytest.mark.parametrize("pattern", ["one_a_block", "every_7th", "0.17",
                                     "0.17 banded"])
def test_twin_matches_jax_on_scan_patterns(rng, pattern):
    # ties across tile edges of 64 and 256, 2600 rays (not a multiple of
    # 256), the scan kernels' live patterns: the twin against the Pallas
    # kernel (interpret mode) and the jnp golden (t_max and live applied
    # after it, as the JAX tracer does)
    soa = _tie_scene()
    R = 2600
    o, d, kw = _aimed_query(rng, soa, R, pattern)
    t_t, i_t = intersect_torch(torch.as_tensor(o), torch.as_tensor(d),
                               soa_from_jax(vars(soa)), chunk_size=1000,
                               **_torch_kw(kw))
    t_t, i_t = t_t.numpy(), i_t.numpy()
    live = kw["live"]
    fn = make_pallas_intersect(soa, interpret=True)
    t_p, i_p = map(np.asarray, fn(
        jnp.asarray(o), jnp.asarray(d),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    _compare_grazing(soa, o[live], d[live], t_p[live], i_p[live], t_t[live],
                     i_t[live], f"scan-patterns/pallas/{pattern}")
    t_j, i_j = map(np.asarray, intersect_jnp(
        jnp.asarray(o), jnp.asarray(d), soa,
        exclude=jnp.asarray(kw["exclude"])))
    keep = (t_j <= kw["t_max"]) & live
    t_j, i_j = np.where(keep, t_j, np.inf), np.where(keep, i_j, -1)
    _compare_grazing(soa, o, d, t_j, i_j, t_t, i_t,
                     f"scan-patterns/jnp/{pattern}")
    assert (i_t[~live] == -1).all()
    # a copy wins its tie only where its original is the excluded one
    h = i_t >= 0
    assert h.any()
    assert ((i_t[h] < 200) | (kw["exclude"][h] == i_t[h] - 200)).all()


def test_twin_miss_and_hit_semantics():
    soa = soa_from_jax(vars(js.flatten_scene(js.simple_reflector_scene())))
    o = torch.tensor([[0.1, 0.2, 1.0], [0.1, 0.2, 1.0], [3.0, 3.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    t, idx = intersect_torch(o, d, soa)
    assert idx.tolist()[1:] == [-1, -1]
    assert idx[0] >= 0 and t[0] == 1.0
    assert torch.isinf(t[1:]).all()
    # excluding the hit triangle removes the hit; t_max below t misses
    t2, i2 = intersect_torch(o, d, soa, exclude=idx.clone())
    assert i2[0] == -1
    t3, i3 = intersect_torch(o, d, soa, t_max=0.5)
    assert (i3 == -1).all()


def test_recompute_hit_t_matches(rng):
    soa = _scene("soup")
    o, d = _rays(rng, 1024, -60, 60)
    _, idx = intersect_jnp(jnp.asarray(o), jnp.asarray(d), soa)
    ref = jax_recompute(jnp.asarray(o), jnp.asarray(d), idx, soa)
    ours = recompute_hit_t(torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(np.array(idx)),
                           soa_from_jax(vars(soa)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-6)


def test_cuda_wrapper_takes_plain_path_on_cpu(rng):
    soa = _scene("box")
    o, d = _rays(rng, 512, -4, 4, z=(0.5, 4.5))
    tris = soa_from_jax(vars(soa))
    kernel = NearestHitKernel()
    t_w, i_w = kernel(torch.as_tensor(o), torch.as_tensor(d), tris,
                      t_max=3.0)
    t_t, i_t = intersect_torch(torch.as_tensor(o), torch.as_tensor(d), tris,
                               t_max=3.0)
    assert kernel.launches == 0
    assert torch.equal(i_w, i_t) and torch.equal(t_w, t_t)


@pytest.mark.parametrize("cull", [False, True])
def test_records_built_once_per_scene(monkeypatch, cull):
    # the scan kernels' triangle records: built once per traced scene
    # (tracer.py::_select_intersect), the same tensor handed to each of the
    # trace's seven queries, equal to triangle_records of the scene
    built, seen = [], []

    def counting(*args):
        built.append(triangle_records(*args))
        return built[-1]

    name = "nearest_hit_culled" if cull else "nearest_hit"
    wrapper = getattr(tracer_module, name)

    def spy(o, d, tris, *args, records=None, **kw):
        seen.append((records, tris))
        return wrapper(o, d, tris, *args, records=records, **kw)

    monkeypatch.setattr(tracer_module, "triangle_records", counting)
    monkeypatch.setattr(tracer_module, name, spy)
    z = np.zeros((1, 3))
    compute_paths(random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0),
                  [[10.0, 5.0, 2.0]], [[-20.0, -10.0, 10.0]], z, z, 3.0, 1,
                  1, 512, 3, device="cpu", cull=cull, compact_rays=True)
    assert len(built) == 1 and len(seen) == 7
    tris = seen[0][1]
    assert all(r is built[0] for r, _ in seen)
    assert built[0].shape == (tris.pad_triangles, 12)
    assert torch.equal(built[0], torch.cat(
        [tris.v0, torch.zeros_like(tris.v0[:, :1]), tris.e1,
         torch.zeros_like(tris.v0[:, :1]), tris.e2,
         torch.zeros_like(tris.v0[:, :1])], dim=1))


def test_brute_block_rays():
    # 256 rays a block while the grid holds 4 blocks an SM, else halved
    # down to 32: an H100's 132 SMs, the canyon's 2^20-ray queries, the cut
    # city's 2^14-ray ones, the LoS query
    assert brute_block_rays(1 << 20, 132) == 256
    assert brute_block_rays(4 * 132 * 256, 132) == 256
    assert brute_block_rays((4 * 132 - 1) * 256, 132) == 128
    assert brute_block_rays(1 << 16, 132) == 64
    assert brute_block_rays(1 << 14, 132) == 32
    assert brute_block_rays(1, 132) == 32
