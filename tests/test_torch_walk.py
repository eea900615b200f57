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
- in any-hit mode, ``blocked = idx >= 0 & t <= t_max`` equal;
- traces with ``walk=True`` equal traces with ``walk=False`` bit for bit (op
  path in both parities, the fused step at physical parity, its material
  gradients too), and agree with the JAX ``trace_paths`` within the tier of
  ``tests/test_torch_tracer.py`` (``testing.slots_agree``).  The kernels
  are tested on the card by ``tests/test_torch_cuda.py``."""
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
from hermespy_rt_tpu_torch.ops.walk import (prepare_walk, prepass_plain,
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
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_jax_walk_and_golden(rng, case):
    build, R, extent, block_tris, group, opts = CASES[case]
    soa = build()
    tris = soa_from_jax(vars(soa))
    o, d = _rays(R, rng, extent)
    t_max = ex = None
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
    assert int((i >= 0).sum()) > R // 50
    _compare(soa, o, d, t_w, i_w, t, i, f"{case}: vs JAX walk")
    _compare(soa, o, d, t_g, i_g, t, i, f"{case}: vs intersect_jnp")
    if t_max is not None:
        dead = t_max < 0
        assert (i.numpy()[dead] == -1).all()
    if case == "ties":
        # every hit is on the original, never on its copy 300 rows later
        hit = i.numpy()[i.numpy() >= 0]
        assert hit.size and (hit < 300).all()


@pytest.mark.parametrize("group", [1, 2])
def test_any_hit_blocked_matches_jax(rng, group):
    soa = _soup(700, 11, 45.0)
    tris = soa_from_jax(vars(soa))
    R = 640
    o, d = _rays(R, rng, 55.0)
    t_max = rng.uniform(0.0, 60.0, R).astype(np.float32)
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
    reach, key = pre(o, d, lim, scene.boxes)
    r2, k2 = prepass_plain(o, d, lim, scene.boxes, scene.block_rays)
    assert torch.equal(reach, r2) and torch.equal(key, k2)
    t, i = wk(o, d, lim, scene, visit_rows(reach, key))
    t_b, i_b = intersect_torch(o, d, tris)
    assert torch.equal(i, i_b) and torch.equal(t, t_b)
    assert pre.launches == 0 and wk.launches == 0
