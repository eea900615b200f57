"""PyTorch port vs JAX package: the visit-list walk for large scenes.

The port's plain prepass and walk (``hermespy_rt_tpu_torch/ops/walk.py``,
the versions CPU tensors run) are held against the JAX walk run as its own
tests run it on the CPU (Pallas interpret mode, ``tests/test_walk.py``), on
the same numpy inputs at the same tile sizes:

- visit rows equal ``_walk_prepass(mode="ray")``'s bit for bit, and the
  fine-tile boxes equal ``_tile_aabbs``;
- ``(t, idx)`` equal the port's brute query bit for bit (both use
  ``mt_hit``), and agree with ``pallas_intersect(walk="resident")`` and
  ``intersect_jnp`` to the tier of ``tests/test_torch_intersect.py``: every
  index flip an f64 edge or tie case, ``t`` within rtol 2e-5 where the index
  agrees (the JAX walk computes Möller–Trumbore as matrix products);
- in any-hit mode, ``blocked = idx >= 0 & t <= t_max`` equal, and
  ``(t, idx)`` the contract's (a ray with a hit still evaluates the tiles
  other rays of its tile reach; the JAX walk's indices up to explained
  flips), which on dense hits differs from the first hit;
- the cases the walk kernel deals differently (1 and 4 rays, one live ray
  a tile, every 7th live, a dead tile among live ones, ties inside a fine
  tile), and the kernel's triangle records equal to ``v0``/``e1``/``e2``;
- traces with ``walk=True`` equal traces with ``walk=False`` bit for bit (op
  path in both parities, the fused step at physical parity, its material
  gradients too), and agree with the JAX ``trace_paths`` within the tier of
  ``tests/test_torch_tracer.py`` (``testing.slots_agree``).  The kernels
  are tested on the card by ``tests/test_torch_cuda.py``."""
import _torch_threads  # noqa: F401  (first: the thread share)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.ops.intersect import intersect_jnp
from hermespy_rt_tpu.ops.intersect_pallas import (_od_rows, _tile_aabbs,
                                                  _walk_prepass,
                                                  pallas_intersect)
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.convert import materials_from_jax, soa_from_jax
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.testing import OUTPUT_FIELDS, slots_agree
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch, mt_hit
from hermespy_rt_tpu_torch.ops.walk import (MAX_BOXES, prepare_walk,
                                            prepass_kept_plain, prepass_plain,
                                            query_limits, tile_aabbs,
                                            visit_rows, walk_group)
from hermespy_rt_tpu_torch.ops.walk_cuda import (WalkKernel,
                                                 WalkPrepassKernel,
                                                 walk_query)
from tests.utils import assert_flips_explained

RX = np.array([[4.0, -3.0, 1.5], [2.0, 1.0, 1.0]], np.float32)
TX = np.array([[-6.0, 5.0, 4.0]], np.float32)
Z = np.zeros((2, 3), np.float32)


def _rays(n, rng, extent):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aimed_rays(n, rng, extent, soa):
    """Rays from random origins, each aimed at a random triangle's centroid
    (so most hit)."""
    T = int(soa.num_triangles)
    cen = np.asarray(soa.v0)[:T] + (np.asarray(soa.e1)[:T]
                                    + np.asarray(soa.e2)[:T]) / 3.0
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = (cen[rng.integers(0, T, n)] - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _soup(n, seed, extent, sort=True):
    return js.flatten_scene(js.random_soup_scene(n, seed=seed, extent=extent),
                            sort_triangles=sort)


def _duplicated_soup():
    """300 random triangles followed by an exact copy of them, in file
    order: every hit is an exact tie between a triangle and its copy 300
    rows later, in another 128-row tile, which the lower index must win."""
    m = js.random_soup_scene(300, seed=4, extent=30.0).meshes[0]
    idx = m.indices.astype(np.int64)
    return js.flatten_scene(js.HostScene([js.HostMesh(
        m.vertices, np.concatenate([idx, idx]),
        material_index=m.material_index, name="dup")]))


def _tile_tie_soup():
    """Five blocks of 64 random triangles, each followed by its exact copy,
    in file order: every hit ties a triangle with its copy 64 rows later in
    the same fine tile of 128, which the lower index must win."""
    m = js.random_soup_scene(320, seed=6, extent=30.0).meshes[0]
    idx = m.indices.astype(np.int64).reshape(5, 64, 3)
    return js.flatten_scene(js.HostScene([js.HostMesh(
        m.vertices, np.concatenate([idx, idx], axis=1).reshape(-1, 3),
        material_index=m.material_index, name="tile_ties")]))


def _jax_visit_rows(soa, o, d, lim, block_rays, block_tris, group):
    r_pad = lim.shape[0]
    od = _od_rows(jnp.asarray(o), jnp.asarray(d), r_pad)
    t_pad = soa.v0.shape[0]
    aabbs = _tile_aabbs(soa, t_pad, block_tris)
    packed = _walk_prepass(od, jnp.asarray(lim)[None, :], aabbs, block_rays,
                           group, mode="ray", interpret=True)
    return np.asarray(aabbs), np.asarray(packed).reshape(packed.shape[0], -1)


@pytest.mark.parametrize("group", [1, 2, 8])
def test_visit_rows_equal_jax_prepass(rng, group):
    soa = _soup(700, 11, 45.0)                 # 768 padded: 24 tiles of 32
    tris = soa_from_jax(vars(soa))
    R = 640
    o, d = _rays(R, rng, 55.0)
    t_max = np.where(np.arange(R) % 5 == 0, -1.0, 1e9).astype(np.float32)
    lim = query_limits(R, 256, t_max=torch.as_tensor(t_max))
    aabbs_j, rows_j = _jax_visit_rows(soa, o, d, lim.numpy(), 256, 32, group)
    scene = prepare_walk(tris, block_rays=256, block_tris=32, group=group)
    assert scene.n_boxes == 24 // group
    np.testing.assert_array_equal(tile_aabbs(tris, 32, 768).numpy(),
                                  aabbs_j[:, :6])
    reach, key = prepass_plain(torch.as_tensor(o), torch.as_tensor(d), lim,
                               scene.boxes, 256)
    rows = visit_rows(reach, key).numpy()
    assert rows.shape == (3, 1 + scene.n_boxes)
    np.testing.assert_array_equal(rows, rows_j[:, :1 + scene.n_boxes])
    assert (rows[:, 0] > 0).all()


def _box_soup(boxes, ties):
    """A soup with one fine tile of 32 triangles per coarse box (group 1):
    each tile's first two triangles span its box's corners (the rest
    copies of the first), so the tile boxes are ``boxes`` exactly; with
    ``ties`` the second half of the tiles repeats the first."""
    C = boxes.shape[0]
    if ties:
        boxes = np.concatenate([boxes[:C - C // 2], boxes[:C // 2]])
    lo, hi = boxes[:, None, :3], boxes[:, None, 3:]
    a = np.concatenate([lo, hi, lo * [[1, 1, 0]] + hi * [[0, 0, 1]]], 1)
    b = np.concatenate([hi, lo, hi * [[1, 1, 0]] + lo * [[0, 0, 1]]], 1)
    tri = np.concatenate([a[:, None], b[:, None],
                          np.repeat(a[:, None], 30, 1)], 1)   # [C, 32, 3, 3]
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(verts.shape[0]).reshape(-1, 3)
    return js.flatten_scene(js.HostScene([js.HostMesh(
        verts, idx, material_index=1, name="boxes")]))


@pytest.mark.parametrize("C,ties,inside", [
    (7, True, False), (56, True, True), (512, False, False),
    (512, True, True)])
def test_prepass_rows_equal_jax_prepass(rng, C, ties, inside):
    """The prepass wrapper's CPU route (the plain prepass and visit rows)
    against JAX's ``_walk_prepass`` on one fine tile a box: equal keys
    across boxes (``ties``), +0.0 keys from rays that start inside a box
    (``inside``: half the rays start in box 0), and C = MAX_BOXES."""
    lo = rng.uniform(-50, 50, (C, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(1, 30, (C, 3)).astype(
        np.float32)], axis=1)
    soa = _box_soup(boxes, ties)
    tris = soa_from_jax(vars(soa))
    R = 700
    o, d = _rays(R, rng, 60.0)
    if inside:
        o[::2] = boxes[0, :3] + rng.uniform(0.2, 0.8, (R // 2, 3)).astype(
            np.float32) * (boxes[0, 3:] - boxes[0, :3])
    t_max = rng.uniform(5, 200, R).astype(np.float32)
    t_max[::7] = -1.0
    lim = query_limits(R, 256, t_max=torch.as_tensor(t_max))
    _, rows_j = _jax_visit_rows(soa, o, d, lim.numpy(), 256, 32, 1)
    scene = prepare_walk(tris, block_rays=256, block_tris=32, group=1)
    n = scene.n_boxes          # C, and a padding tile's box past 7
    assert n == max(C, 8)
    pre = WalkPrepassKernel()
    rows = pre(torch.as_tensor(o), torch.as_tensor(d), lim, scene.boxes)
    assert rows.shape == (3, 1 + n) and pre.launches == 0
    np.testing.assert_array_equal(rows.numpy(), rows_j[:, :1 + n])
    if ties:     # equal keys: a box and its copy, the lower one first
        assert (rows[:, 0] > 1).all()
    if inside:   # box 0 keyed +0.0, first in every row
        assert (rows[:, 1] == 0).all()


@pytest.mark.parametrize("coherent", [False, True])
def test_prepass_prune_keeps_every_reached_box(rng, coherent):
    """The prepass kernel's prune (``prepass_kept_plain``) keeps every box
    a ray of the tile reaches (the padding tile's inverted box, every ray's
    at key 0, among them), and prunes part of the rest when a tile's rays
    are coherent."""
    soa = _soup(3000, 5, 60.0)
    tris = soa_from_jax(vars(soa))
    scene = prepare_walk(tris, block_tris=32)
    R = 1500
    if coherent:     # one origin, directions sorted
        o = np.broadcast_to(np.float32([3.0, -2.0, 9.0]), (R, 3)).copy()
        d = rng.normal(size=(R, 3)).astype(np.float32)
        d = d[np.lexsort((d[:, 1], d[:, 0], np.sign(d[:, 2])))]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    else:
        o, d = _rays(R, rng, 70.0)
    d[::11, 1] = 0.0
    t_max = rng.uniform(1, 90, R).astype(np.float32)
    t_max[::5] = -1.0
    lim = query_limits(R, 256, t_max=torch.as_tensor(t_max))
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    reach, _ = prepass_plain(o, d, lim, scene.boxes, 256)
    kept = prepass_kept_plain(o, d, lim, scene.boxes, 256)
    assert kept.shape == reach.shape
    assert bool((kept | ~reach).all())            # kept covers reached
    assert bool(reach.any())
    if coherent:
        assert float(kept.float().mean()) < 0.7


def test_prepass_takes_at_most_max_boxes(rng):
    o, d = (torch.as_tensor(x) for x in _rays(10, rng, 5.0))
    lim = query_limits(10, 256)
    boxes = torch.zeros((MAX_BOXES + 1, 6))
    with pytest.raises(ValueError, match=f"MAX_BOXES = {MAX_BOXES}"):
        WalkPrepassKernel()(o, d, lim, boxes)
    assert WalkPrepassKernel()(o, d, lim, boxes[:MAX_BOXES]).shape == (
        1, 1 + MAX_BOXES)


def test_triangle_records_equal_triangles():
    """The walk kernel's 48-byte records hold (v0, 0, e1, 0, e2, 0) bit for
    bit, the padding triangles as zeros, 16-byte aligned."""
    tris = soa_from_jax(vars(_soup(700, 11, 45.0)))
    scene = prepare_walk(tris, block_tris=64, group=8)       # 768 -> 1024
    rec = scene.records
    assert rec.shape == (1024, 12) and rec.dtype == torch.float32
    assert rec.is_contiguous() and rec.data_ptr() % 16 == 0
    for c, x in enumerate((scene.v0, scene.e1, scene.e2)):
        assert torch.equal(rec[:, 4 * c:4 * c + 3].view(torch.int32),
                           x.view(torch.int32))
        assert not bool(rec[:, 4 * c + 3].view(torch.int32).any())
    assert torch.equal(scene.v0[:tris.pad_triangles], tris.v0)
    assert not bool(rec[tris.pad_triangles:].view(torch.int32).any())


def test_group_rule_matches_jax():
    # JAX: the smallest power of two with n_tiles <= 512 * group
    for n, g in ((1, 1), (512, 1), (513, 2), (1024, 2), (1025, 4),
                 (4097, 16)):
        assert walk_group(n) == g
    soa = soa_from_jax(vars(_soup(700, 11, 45.0)))
    assert prepare_walk(soa).block_tris == 128     # 768 rounds to 768
    assert prepare_walk(soa, block_tris=4096).block_tris == 768


def _compare(soa, o, d, t_ref, i_ref, t, i, label):
    t_ref, i_ref, t, i = map(np.asarray, (t_ref, i_ref, t, i))
    assert_flips_explained(soa, o, d, t_ref, i_ref, t, i, label=label)
    m = (i_ref == i) & (i >= 0)
    np.testing.assert_allclose(t[m], t_ref[m], rtol=2e-5, err_msg=label)


CASES = {
    # (soup builder, rays, ray extent, block_tris, group, options)
    "morton_soup": (lambda: _soup(900, 3, 50.0), 512, 60.0, 128, 0, ()),
    "t_max_dead_ragged": (lambda: _soup(700, 11, 45.0), 777, 40.0, 64, 0,
                          ("t_max_rows",)),
    "grouped_2": (lambda: _soup(700, 11, 45.0), 640, 55.0, 32, 2,
                  ("dead",)),
    "grouped_8": (lambda: _soup(700, 11, 45.0), 640, 55.0, 32, 8,
                  ("dead",)),
    "exclude": (lambda: _soup(600, 2, 40.0), 600, 50.0, 64, 0,
                ("exclude",)),
    "ties": (_duplicated_soup, 512, 35.0, 128, 0, ()),
    # the shapes the walk kernel deals differently: the LoS query's 1 ray
    # and nrx = 4's 4, one live ray in each ray tile, every 7th live, a
    # dead ray tile between live ones, ties inside one fine tile
    "los_1": (lambda: _soup(900, 3, 50.0), 1, 60.0, 128, 0, ("aimed",)),
    "los_4": (lambda: _soup(900, 3, 50.0), 4, 60.0, 128, 2, ("aimed",)),
    "one_live_a_tile": (lambda: _soup(900, 3, 50.0), 777, 60.0, 128, 0,
                        ("aimed", "one_live")),
    "every_7th_live": (lambda: _soup(700, 11, 45.0), 640, 55.0, 64, 0,
                       ("every_7th",)),
    "dead_tile": (lambda: _soup(700, 11, 45.0), 768, 55.0, 64, 2,
                  ("dead_tile",)),
    "ties_in_tile": (_tile_tie_soup, 512, 35.0, 128, 0, ("aimed",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_jax_walk_and_golden(rng, case):
    build, R, extent, block_tris, group, opts = CASES[case]
    soa = build()
    tris = soa_from_jax(vars(soa))
    o, d = (_aimed_rays(R, rng, extent, soa) if "aimed" in opts
            else _rays(R, rng, extent))
    t_max = ex = None
    r = np.arange(R)
    live_only = {"one_live": r % 256 == 5, "every_7th": r % 7 == 0,
                 "dead_tile": r // 256 != 1}
    for opt, live in live_only.items():
        if opt in opts:
            t_max = np.where(live, 1e9, -1.0).astype(np.float32)
    if "t_max_rows" in opts:
        t_max = np.where(np.arange(R) % 3 == 0, -1.0,
                         np.where(np.arange(R) % 3 == 1, 1.0, 1e9)
                         ).astype(np.float32)
    if "dead" in opts:
        t_max = np.where(np.arange(R) % 5 == 0, -1.0, 1e9).astype(np.float32)
    if "exclude" in opts:
        ex = rng.integers(-1, soa.v0.shape[0], R).astype(np.int32)
    jkw = {}
    if t_max is not None:
        jkw["t_max"] = jnp.asarray(t_max)
    if ex is not None:
        jkw["exclude"] = jnp.asarray(ex)
    t_w, i_w = pallas_intersect(jnp.asarray(o), jnp.asarray(d), soa,
                                block_rays=256, block_tris=block_tris,
                                interpret=True, precision="highest",
                                walk="resident", walk_group=group, **jkw)
    t_g, i_g = intersect_jnp(jnp.asarray(o), jnp.asarray(d), soa,
                             exclude=jkw.get("exclude"))
    t_g, i_g = np.asarray(t_g), np.asarray(i_g)
    if t_max is not None:
        within = t_g <= t_max
        t_g, i_g = np.where(within, t_g, np.inf), np.where(within, i_g, -1)

    scene = prepare_walk(tris, block_rays=256, block_tris=block_tris,
                         group=group or None)
    kw = {}
    if t_max is not None:
        kw["t_max"] = torch.as_tensor(t_max)
    if ex is not None:
        kw["exclude"] = torch.as_tensor(ex)
    t, i = walk_query(torch.as_tensor(o), torch.as_tensor(d), scene, **kw)
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    t_b, i_b = intersect_torch(torch.as_tensor(o), torch.as_tensor(d), tris,
                               **kw)
    assert torch.equal(i, i_b) and torch.equal(t, t_b)
    n_live = R if t_max is None else int((t_max >= 0).sum())
    assert int((i >= 0).sum()) > min(R // 50, n_live // 20)
    _compare(soa, o, d, t_w, i_w, t, i, f"{case}: vs JAX walk")
    _compare(soa, o, d, t_g, i_g, t, i, f"{case}: vs intersect_jnp")
    if t_max is not None:
        dead = t_max < 0
        assert (i.numpy()[dead] == -1).all()
    if case == "ties":
        # every hit is on the original, never on its copy 300 rows later
        hit = i.numpy()[i.numpy() >= 0]
        assert hit.size and (hit < 300).all()
    if case == "ties_in_tile":
        # ... and on the original 64 rows before its copy, in one tile
        hit = i.numpy()[i.numpy() >= 0]
        assert hit.size and ((hit // 64) % 2 == 0).all()


def _any_hit_walk(o, d, scene, visits, lim, first_hit_only):
    """The any-hit walk written out ray tile by ray tile, fine tile by fine
    tile, as ``ops/walk.py`` states it: a ray with a hit no longer reaches
    tiles (its limit is -1) but evaluates, within its own ``lim``, every
    tile that another ray of its tile reaches.  With ``first_hit_only`` it
    stops evaluating too: not the contract, the answer a kernel that skipped
    such rays would give."""
    br, bt, g = scene.block_rays, scene.block_tris, scene.group
    R, n_pad = o.shape[0], lim.shape[0]
    o = torch.cat([o, o.new_zeros((n_pad - R, 3))])
    d = torch.cat([d, d.new_zeros((n_pad - R, 3))])
    inv = 1.0 / torch.where(d == 0, 1e-30, d)
    best_t = torch.full((n_pad,), torch.inf)
    best_i = torch.full((n_pad,), 2 ** 31 - 1, dtype=torch.int64)
    for rt in range(n_pad // br):
        s = slice(rt * br, (rt + 1) * br)
        for e in range(int(visits[rt, 0])):
            for m in range(g):
                j = int(visits[rt, 1 + e]) * g + m
                has = best_t[s] < torch.inf
                limit = torch.where(has, -1.0, torch.minimum(best_t[s],
                                                             lim[s]))
                lo, hi = scene.aabbs[j, 0:3], scene.aabbs[j, 3:6]
                t_n = torch.amax(torch.minimum((lo - o[s]) * inv[s],
                                               (hi - o[s]) * inv[s]), dim=1)
                t_f = torch.amin(torch.maximum((lo - o[s]) * inv[s],
                                               (hi - o[s]) * inv[s]), dim=1)
                if not bool(((t_f >= 0) & (t_n <= t_f) & (t_n <= limit)
                             & (limit >= 0)).any()):
                    continue
                k = torch.arange(j * bt, (j + 1) * bt)
                t, valid = mt_hit(
                    tuple(o[s][:, c:c + 1] for c in range(3)),
                    tuple(d[s][:, c:c + 1] for c in range(3)),
                    *(tuple(x[k][None, :, c] for c in range(3))
                      for x in (scene.v0, scene.e1, scene.e2)))
                ev_lim = torch.where(has, -1.0, lim[s]) if first_hit_only \
                    else lim[s]
                t = torch.where(valid & (t <= ev_lim[:, None]), t,
                                torch.inf)
                t_min, arg = torch.min(t, dim=1)
                idx = arg + j * bt
                better = (t_min < best_t[s]) | ((t_min == best_t[s])
                                                & (idx < best_i[s]))
                best_t[s] = torch.where(better, t_min, best_t[s])
                best_i[s] = torch.where(better, idx, best_i[s])
    t = best_t[:R]
    return t, torch.where(torch.isfinite(t), best_i[:R], -1).to(torch.int32)


@pytest.mark.parametrize("group,aimed", [
    pytest.param(1, False, id="1"), pytest.param(2, False, id="2"),
    pytest.param(2, True, id="aimed")])
def test_any_hit_blocked_matches_jax(rng, group, aimed):
    # aimed: a dense soup crossed by rays aimed at its triangles, with limits
    # past them, so most rays hit and many could hit again
    soa = _soup(700, 11, 15.0 if aimed else 45.0)
    tris = soa_from_jax(vars(soa))
    R = 640
    o, d = _aimed_rays(R, rng, 20.0, soa) if aimed else _rays(R, rng, 55.0)
    t_max = rng.uniform(*((20.0, 60.0) if aimed else (0.0, 60.0)),
                        R).astype(np.float32)
    t_max[::7] = -1.0
    t_j, i_j = pallas_intersect(jnp.asarray(o), jnp.asarray(d), soa,
                                block_rays=256, block_tris=32,
                                interpret=True, precision="highest",
                                walk="resident", walk_group=group,
                                t_max=jnp.asarray(t_max), any_hit=True)
    scene = prepare_walk(tris, block_rays=256, block_tris=32, group=group)
    tm = torch.as_tensor(t_max)
    t, i = walk_query(torch.as_tensor(o), torch.as_tensor(d), scene,
                      t_max=tm, any_hit=True)
    t_b, i_b = intersect_torch(torch.as_tensor(o), torch.as_tensor(d), tris,
                               t_max=tm)
    blocked = ((i >= 0) & (t <= tm)).numpy()
    assert blocked.any() and not blocked.all()
    np.testing.assert_array_equal(blocked, ((i_b >= 0) & (t_b <= tm)).numpy())
    np.testing.assert_array_equal(
        blocked, (np.asarray(i_j) >= 0) & (np.asarray(t_j) <= t_max))
    # every reported hit is a hit of that triangle within the limit
    hit = torch.as_tensor(blocked)
    sel = i[hit].long()

    def comp(x):
        return tuple(x[:, c] for c in range(3))

    t_re, valid = mt_hit(comp(torch.as_tensor(o)[hit]),
                         comp(torch.as_tensor(d)[hit]), comp(tris.v0[sel]),
                         comp(tris.e1[sel]), comp(tris.e2[sel]))
    assert bool(valid.all()) and torch.equal(t_re, t[hit])
    # (t, idx) is the contract's: a ray that already hit still evaluates the
    # tiles that other rays of its tile reach, which changes the answer of
    # some rays from their first hit; the JAX walk keeps the same contract
    lim = query_limits(R, 256, t_max=tm)
    visits = visit_rows(*prepass_plain(torch.as_tensor(o), torch.as_tensor(d),
                                       lim, scene.boxes, 256))
    args = (torch.as_tensor(o), torch.as_tensor(d), scene, visits, lim)
    t_c, i_c = _any_hit_walk(*args, first_hit_only=False)
    assert torch.equal(i_c, i) and torch.equal(t_c, t)
    if aimed:       # most rays hit, so some hit again in later tiles
        _, i_f = _any_hit_walk(*args, first_hit_only=True)
        assert bool((i_f != i).any())
    assert_flips_explained(soa, o, d, np.asarray(t_j), np.asarray(i_j),
                           t.numpy(), i.numpy(), label="vs JAX any-hit")


def _trace(tris, mats, nrx, cfg):
    res = trace_paths(tris, mats, RX[:nrx], TX, Z[:nrx], Z[:1], 3.0, cfg)
    loss = (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e6
    loss.backward()
    return res, {f: getattr(mats, f).grad for f in MATERIAL_FIELDS
                 if getattr(mats, f).grad is not None}


@pytest.mark.parametrize("parity,shade,nrx", [
    ("reference", "xla", 2), ("physical", "xla", 1), ("physical", "xla", 2),
    ("physical", "fused", 2)])
def test_trace_walk_equals_brute_and_jax(parity, shade, nrx, monkeypatch):
    """``random_soup_scene(600, seed=11, extent=14)``, Morton-sorted, as
    ``tests/test_config5.py`` traces it."""
    soa = _soup(600, 11, 14.0)
    tris = soa_from_jax(vars(soa))
    kw = dict(num_paths=512, num_bounces=3, keep_rays=False, parity=parity,
              compact_rays=True)
    if shade == "fused":
        kw.update(shade="fused", grad_positions=False, grad_geometry=False)
    queries = []
    real = tracer_module.walk_query

    def spy(*args, **kwargs):
        queries.append(kwargs.get("any_hit"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tracer_module, "walk_query", spy)
    out = {}
    for walk in (False, True):
        out[walk] = _trace(tris, materials_from_jax(vars(jax_materials())),
                           nrx, TracerConfig(walk=walk, **kw))
    # LoS, then per bounce one bounce query and one shadow query (any-hit
    # under physical parity)
    assert queries == [False] + [False, parity == "physical"] * 3
    (res0, g0), (res1, g1) = out[False], out[True]
    for part in ("los", "scatter"):
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
            assert torch.equal(getattr(getattr(res0, part), f),
                               getattr(getattr(res1, part), f)), (part, f)
    assert g0.keys() == g1.keys() and g0
    for f in g0:
        assert torch.equal(g0[f], g1[f]), f
    written = res1.scatter.a_te.abs() > 0
    assert written.any() and not written.all()

    ref = jax_trace(soa, jax_materials(), RX[:nrx], TX, Z[:nrx], Z[:1], 3.0,
                    JaxConfig(backend="jnp", num_paths=512, num_bounces=3,
                              keep_rays=False, parity=parity))
    for f in OUTPUT_FIELDS:
        slots_agree(torch.as_tensor(np.asarray(getattr(ref.scatter, f))),
                    getattr(res1.scatter, f), f)


def test_walk_knobs():
    assert TracerConfig().walk == "auto" and TracerConfig().shadow_any_hit
    for w in ("resident", "dma"):
        with pytest.raises(ValueError, match="TPU"):
            TracerConfig(walk=w)
    with pytest.raises(ValueError):
        TracerConfig(walk="tile")
    small = soa_from_jax(vars(_soup(600, 11, 14.0)))
    large = soa_from_jax(vars(js.flatten_scene(
        js.random_soup_scene(4000, seed=1))))      # 4096 padded
    for tris, cfg, walks in ((small, TracerConfig(), False),
                             (large, TracerConfig(), True),
                             (large, TracerConfig(backend="torch"), False),
                             (small, TracerConfig(walk=True), True),
                             (large, TracerConfig(walk=False), False)):
        assert tracer_module._walks(cfg, tris) is walks


def test_wrappers_take_plain_path_on_cpu(rng):
    soa = _soup(700, 11, 45.0)
    tris = soa_from_jax(vars(soa))
    scene = prepare_walk(tris, block_tris=64)
    o, d = (torch.as_tensor(x) for x in _rays(300, rng, 50.0))
    lim = query_limits(300, scene.block_rays)
    pre, wk = WalkPrepassKernel(), WalkKernel()
    visits = pre(o, d, lim, scene.boxes)
    assert torch.equal(visits, visit_rows(*prepass_plain(
        o, d, lim, scene.boxes, scene.block_rays)))
    t, i = wk(o, d, lim, scene, visits)
    t_b, i_b = intersect_torch(o, d, tris)
    assert torch.equal(i, i_b) and torch.equal(t, t_b)
    assert pre.launches == 0 and wk.launches == 0
