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
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.ops.intersect import intersect_jnp
from hermespy_rt_tpu.ops.intersect import recompute_hit_t as jax_recompute
from hermespy_rt_tpu.ops.intersect_pallas import make_pallas_intersect
from hermespy_rt_tpu_torch.convert import soa_from_jax
from hermespy_rt_tpu_torch.ops.intersect import (intersect_torch,
                                                 recompute_hit_t)
from hermespy_rt_tpu_torch.ops.intersect_cuda import NearestHitKernel
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
