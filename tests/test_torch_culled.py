"""PyTorch port vs JAX package: the culled nearest-hit query (``cull=True``).

``culled_reach_plain`` (which tiles of 64 triangles each block of 256 rays
reaches: the culled kernel's skip decisions) is held against the slab test
recomputed here in numpy, from the JAX package's ``_tile_aabbs`` and each
ray's running nearest hit over the tiles before (the plain brute query on
each tile's triangles), bit for bit: the same f32 operations, NaN-propagating
min and max.  The port's culled query on the CPU (the culled kernel's
wrapper, which runs the plain brute query there) is held against JAX's
``pallas_intersect(cull=True)`` in interpret mode, with and without ``t_max``
and ``live``, to the tier of ``tests/test_torch_intersect.py`` (every
decision flip an f64 edge or tie case, ``t`` to rtol 2e-5).  The kernel
itself is tested on the card by ``tests/test_torch_cuda.py``."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.ops.intersect_pallas import _tile_aabbs, pallas_intersect
from hermespy_rt_tpu_torch.convert import soa_from_jax
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch
from hermespy_rt_tpu_torch.ops.intersect_cuda import nearest_hit_culled
from hermespy_rt_tpu_torch.ops.walk import (CULL_BLOCK_RAYS, CULL_BLOCK_TRIS,
                                            cull_boxes, culled_reach_plain,
                                            query_limits)
from tests.test_torch_intersect import (_aimed_query, _compare, _options,
                                        _rays, _scene, _tie_scene)


def _np_reach(o, d, lo, hi, lim, tile_t):
    """The culled kernel's reach per (ray tile, tile) in numpy f32: each
    ray's slab test against the tile's box within min(its nearest hit over
    the tiles before, lim)."""
    best = np.minimum.accumulate(np.concatenate(
        [np.full((o.shape[0], 1), np.inf, np.float32), tile_t[:, :-1]],
        axis=1), axis=1)
    limit = np.minimum(best, lim[:, None])
    inv = np.float32(1.0) / np.where(d == 0, np.float32(1e-30), d)
    t_near = t_far = None
    for a in range(3):
        p = (lo[None, :, a] - o[:, None, a]) * inv[:, None, a]
        q = (hi[None, :, a] - o[:, None, a]) * inv[:, None, a]
        na, fa = np.minimum(p, q), np.maximum(p, q)
        t_near = na if a == 0 else np.maximum(t_near, na)
        t_far = fa if a == 0 else np.minimum(t_far, fa)
    reach = ((t_far >= 0) & (t_near <= t_far) & (t_near <= limit)
             & (limit >= 0))
    return reach.reshape(-1, CULL_BLOCK_RAYS, reach.shape[1]).any(axis=1)


@pytest.mark.parametrize("opt", ["plain", "all"])
def test_culled_reach_matches_numpy_slab_test(rng, opt):
    # Morton-sorted, so that a tile's triangles lie near each other
    soa = js.flatten_scene(js.random_soup_scene(234, seed=0, extent=90.0,
                                                tri_size=8.0),
                           sort_triangles=True)
    tris = soa_from_jax(vars(soa))
    T = tris.pad_triangles
    # ray tiles: random rays; narrow cones from the TX, from outside the
    # scene towards it, and away from it; a ragged last tile
    R = 4 * CULL_BLOCK_RAYS + 77
    o, d = _rays(rng, R, -60, 60)
    cones = [([-20.0, -10.0, 10.0], [1.0, 0.2, 0.0]),
             ([150.0, 10.0, 0.0], [-1.0, 0.0, 0.0]),
             ([150.0, 10.0, 0.0], [1.0, 0.0, 0.0])]
    for k, (origin, axis) in enumerate(cones, start=1):
        sl = slice(k * CULL_BLOCK_RAYS, (k + 1) * CULL_BLOCK_RAYS)
        cone = np.float32(axis) + 0.05 * rng.normal(size=(CULL_BLOCK_RAYS, 3))
        d[sl] = cone / np.linalg.norm(cone, axis=1, keepdims=True)
        o[sl] = origin
    kw = {k: torch.as_tensor(v) for k, v in _options(rng, opt, R, T).items()}
    ref = _hold_reach(soa, tris, o, d, kw)
    assert 0 < int(ref.sum()) < ref.size       # some tiles skipped, some not


def _hold_reach(soa, tris, o, d, kw):
    """``culled_reach_plain``'s reach against the numpy slab test on JAX's
    ``_tile_aabbs``, each ray's nearest hit per tile within its limit from
    the brute query on the tile's triangles; its answer against the brute
    query's.  Returns the reference reach."""
    R, T = o.shape[0], tris.pad_triangles
    lim = query_limits(R, CULL_BLOCK_RAYS, t_max=kw.get("t_max"),
                       live=kw.get("live"))
    reach, t, idx = culled_reach_plain(torch.as_tensor(o), torch.as_tensor(d),
                                       tris, lim, exclude=kw.get("exclude"))
    n_t = -(-T // CULL_BLOCK_TRIS)
    assert reach.shape == (lim.shape[0] // CULL_BLOCK_RAYS, n_t)
    assert torch.equal(cull_boxes(tris), torch.as_tensor(np.asarray(
        _tile_aabbs(soa, n_t * CULL_BLOCK_TRIS, CULL_BLOCK_TRIS))[:, :6]))
    # its answer is the brute query's
    t_b, i_b = intersect_torch(torch.as_tensor(o), torch.as_tensor(d), tris,
                               **kw)
    assert torch.equal(idx, i_b) and torch.equal(t, t_b)

    # the slab test in numpy from JAX's boxes; each ray's nearest hit per
    # tile within its limit from the brute query on the tile's triangles
    boxes = np.asarray(_tile_aabbs(soa, n_t * CULL_BLOCK_TRIS,
                                   CULL_BLOCK_TRIS))
    lim_np = lim.numpy()
    n_pad = lim_np.shape[0]
    tile_t = np.full((n_pad, n_t), np.inf, np.float32)
    for j in range(n_t):
        sl = slice(j * CULL_BLOCK_TRIS, (j + 1) * CULL_BLOCK_TRIS)
        part = types.SimpleNamespace(v0=tris.v0[sl], e1=tris.e1[sl],
                                     e2=tris.e2[sl])
        ex = kw.get("exclude")
        t_j, _ = intersect_torch(
            torch.as_tensor(o), torch.as_tensor(d), part,
            exclude=None if ex is None else ex - j * CULL_BLOCK_TRIS)
        t_j = t_j.numpy()
        tile_t[:R, j] = np.where(t_j <= lim_np[:R], t_j, np.inf)
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, np.zeros((n_pad - R, 3), np.float32)])
    ref = _np_reach(pad(o), pad(d), boxes[:, 0:3], boxes[:, 3:6], lim_np,
                    tile_t)
    np.testing.assert_array_equal(reach.numpy(), ref)
    return ref


@pytest.mark.parametrize("pattern", ["one_a_block", "every_7th", "0.17",
                                     "0.17 banded"])
def test_culled_reach_on_scan_patterns(rng, pattern):
    # the scan kernels' live patterns, 2600 rays (not a multiple of 256),
    # ties across tile edges of 64 (tests/test_torch_intersect.py)
    soa = _tie_scene()
    tris = soa_from_jax(vars(soa))
    o, d, kw = _aimed_query(rng, soa, 2600, pattern)
    ref = _hold_reach(soa, tris, o, d, {k: torch.as_tensor(v)
                                        for k, v in kw.items()})
    assert int(ref.sum()) > 0
    if pattern in ("one_a_block", "0.17 banded"):
        # blocks of one live ray, or none: some tiles are skipped (with
        # ~40 scattered live rays a block, every tile is reached)
        assert int(ref.sum()) < ref.size


@pytest.mark.parametrize("opt", ["plain", "t_max_rays", "live", "all"])
@pytest.mark.parametrize("name", ["soup", "box"])
def test_culled_query_matches_pallas_culled(rng, name, opt):
    soa = _scene(name)
    R = 1024
    o, d = (_rays(rng, R, -60, 60) if name == "soup"
            else _rays(rng, R, -4, 4, z=(0.5, 4.5)))
    kw = _options(rng, opt, R, soa.pad_triangles)
    t_p, i_p = pallas_intersect(jnp.asarray(o), jnp.asarray(d), soa,
                                block_tris=128, interpret=True, cull=True,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    tris = soa_from_jax(vars(soa))
    t_c, i_c = nearest_hit_culled(
        torch.as_tensor(o), torch.as_tensor(d), tris, cull_boxes(tris),
        **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert nearest_hit_culled.launches == 0
    _compare(soa, o, d, t_p, i_p, t_c.numpy(), i_c.numpy(),
             label=f"culled-vs-pallas/{name}/{opt}")
    if "live" in kw:    # dead rays miss on both sides
        dead = ~kw["live"]
        assert (np.asarray(i_p)[dead] == -1).all()
        assert (i_c.numpy()[dead] == -1).all()
