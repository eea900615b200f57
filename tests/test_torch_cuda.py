"""Tests of the CUDA kernels on the card.

They need an NVIDIA GPU with nvcc and skip elsewhere.  The file imports no
JAX, so it runs where JAX is absent; run it from the repo root without the
repo's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The nearest-hit kernel must make exactly the decisions of its plain torch
twin on the same card (both round every product and sum on its own, in the
same order), and the trace through it must agree with the trace through the
twin to the tier of ``tests/test_pallas.py``.  The fused bounce kernels are
held against their plain versions with the checks of
``hermespy_rt_tpu_torch/testing.py`` (equal decisions, values within their
tier, the backward against the plain version in float64 and the same bits
in two runs), and one fused forward+backward step against the op path.
So are the per-stage backwards of the full-gradient fused path and the
table scatter-add (per-ray rows within their tier of the float64 plain
version, sums across rays within theirs, the same bits in two runs), and
that path's gradients (materials, positions, frequency, vertices) against
the op path's.
The brute and culled scans must give ``intersect_torch``'s bits, and the
culled one the plain version's skip count, at every live share, ray count,
triangle count and tie the tests plant.
The row gather must equal ``table[idx]`` bit for bit; the shading kernel
its plain version on a trace's recorded calls (a dead ray's state bit for
bit, the rest within its tier); the culled query the brute twin's decisions
and its skip count the plain version's; the op path with every kernel
(``shade="pallas", cull=True``) the op path's gradients.
The walk's prepass kernel must give the visit rows of its plain version
(``visit_rows`` of ``prepass_plain``) bit for bit, at every box count up to
``MAX_BOXES``, ray count, live share and tie the tests plant, and refuse
more boxes; the full pre and post backwards their plain versions' values
within their tiers at every RX count, parity, payload width and ray count,
the same bits in two runs (the post backward, which sums across rays in its
last block, in three); the whole-loop backward at 1, 17 and 300 materials,
1 and 3 bounces and every ray count, the same bits in three runs; kernels
13-16 the same bits in two runs on a recorded call, within their tiers;
kernel 14 also on seeded operands at every live share and with a tail
warp (``d_st`` and a dead ray's eta row the plain version's bits), and a
step on a 5,000-row material table through the per-stage kernels.
The walk kernel must give the (t, idx) of its plain version and of the
brute kernel (in any-hit mode the same `blocked`, each reported hit a
valid one); traces through the walk equal traces through the brute kernel
bit for bit, and on the box city at 2^20 paths the default trace, which
walks only live rays, equals ``compact_rays=False``'s bit for bit.  There
the default drop (``shade="auto"``) runs the fused forward (two kernels a
bounce, no backward kernel) and agrees with ``shade="xla"`` (the same
written slots, values within the fused tier).  On the O2I cell's scene and
flags, with 5 RX drawn by its entry (4 indoor), the default drop runs the
fused forward's transmission variants (two kernels a bounce, no warning,
no blocker-row gather); under each transmission mode alone and both,
each launch is held against its plain version (equal decisions, values
within their tier); and the default drop agrees with ``shade="xla"``:
the same written slots, values within the fused tier and no sampled entry
beyond the benchmark's tolerances.
Under the transmission modes a calibration step makes the launches
``testing.transmission_launches`` counts, agrees with the same step
through ``backend="torch"`` (slots; gradients within the op path's tier),
and every gather, shading call, culled query and scatter-add it records
holds against its plain version; ``shade="fused"`` warns and gives the op
path's bits; the walk, answering the shadow queries with the nearest
blocker, gives the brute scan's trace bit for bit."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses
import os
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hermespy_rt_tpu_torch import compute_paths, default_materials
from hermespy_rt_tpu_torch import measure
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.ops.bounce_fused import (FusedSpec,
                                                    bounce_pre_bwd_slim_plain)
from hermespy_rt_tpu_torch.ops.fetch import scatter_add_ordered_plain
from hermespy_rt_tpu_torch.ops.fetch_cuda import gather, scatter_add
from hermespy_rt_tpu_torch.ops.fresnel import ETA_FIELDS, precompute_eta
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch, mt_hit
from hermespy_rt_tpu_torch.ops.intersect_cuda import (nearest_hit,
                                                      nearest_hit_culled)
from hermespy_rt_tpu_torch.ops.shade_cuda import shade_a
from hermespy_rt_tpu_torch.ops.walk import (cull_boxes, prepare_walk,
                                            prepass_plain, query_limits,
                                            triangle_records, visit_rows,
                                            walk_plain)
from hermespy_rt_tpu_torch.ops.walk_cuda import walk, walk_prepass, walk_query
from hermespy_rt_tpu_torch.scene import (HostMesh, HostScene, box_scene,
                                         flatten_scene, load_scene, make_city,
                                         random_soup_scene)
from hermespy_rt_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

RX = np.array([[10.0, 5.0, 2.0], [11.5, 3.0, 2.25], [13.0, 1.0, 2.5]],
              np.float32)
TX = np.array([[-20.0, -10.0, 10.0]], np.float32)
FREQ = 3.0


def _step(tris, nrx, mats, paths, fused, **kw):
    cfg = checks.calibration_config(paths, 3, fused, **kw)
    return checks.calibration_step(tris, RX[:nrx], TX, FREQ, mats, cfg)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _inputs(rng, opt, R, T, dev):
    o = rng.uniform(-80, 80, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = {}
    if opt in ("exclude", "all"):
        kw["exclude"] = rng.integers(-1, T, R).astype(np.int32)
    if opt == "t_max":
        kw["t_max"] = 20.0
    if opt in ("t_max_rays", "all"):
        kw["t_max"] = rng.uniform(0, 60, R).astype(np.float32)
    if opt in ("live", "all"):
        kw["live"] = rng.uniform(size=R) < 0.6
    kw = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
          else v for k, v in kw.items()}
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), kw


@pytest.mark.parametrize("opt", ["plain", "exclude", "t_max", "t_max_rays",
                                 "live", "all"])
@pytest.mark.parametrize("scene", ["soup", "box"])
def test_kernel_equals_twin(dev, scene, opt):
    rng = np.random.default_rng(5)
    host = (random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0)
            if scene == "soup" else box_scene())
    tris = flatten_scene(host, device=dev)
    R = (1 << 16) + 77          # a ragged last block
    o, d, kw = _inputs(rng, opt, R, tris.pad_triangles, dev)
    before = nearest_hit.launches
    t_k, i_k = nearest_hit(o, d, tris, **kw)
    torch.cuda.synchronize()
    assert nearest_hit.launches == before + 1
    t_t, i_t = intersect_torch(o, d, tris, chunk_size=8192, **kw)
    assert torch.equal(i_k, i_t)
    assert torch.equal(t_k, t_t)


def test_kernel_rejects_bad_operands(dev):
    tris = flatten_scene(box_scene(), device=dev)
    o = torch.zeros((8, 3), device=dev)
    d = torch.ones((8, 3), device=dev)
    with pytest.raises(ValueError):
        nearest_hit(o.double(), d, tris)
    with pytest.raises(ValueError):
        nearest_hit(o, d, tris, exclude=torch.zeros(8, dtype=torch.int64,
                                                     device=dev))
    with pytest.raises(ValueError):
        nearest_hit(o, d.t().contiguous().t(), tris)
    with pytest.raises(ValueError):
        nearest_hit(o, d.cpu(), tris)


def test_trace_through_kernel_matches_twin(dev):
    rx = np.array([[10.0, 5.0, 2.0], [11.5, 3.0, 2.25]], np.float32)
    tx = np.array([[-20.0, -10.0, 10.0]], np.float32)
    z = np.zeros((2, 3))
    host = random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0)
    out = {}
    for backend in ("cuda", "torch"):
        before = nearest_hit.launches
        out[backend] = compute_paths(host, rx, tx, z, z[:1], 3.0, 2, 1,
                                     1 << 14, 3, device=dev, backend=backend,
                                     keep_rays=False)
        launched = nearest_hit.launches - before
        assert launched == (7 if backend == "cuda" else 0)
    for part in (0, 1):
        for f in ("a_te", "a_tm", "tau", "freq_shift"):
            a = getattr(out["torch"][part], f).cpu().numpy()
            b = getattr(out["cuda"][part], f).cpu().numpy()
            assert ((np.abs(a) > 0) == (np.abs(b) > 0)).mean() > 0.995, f
            m = (np.abs(a) > 0) & (np.abs(b) > 0)
            if m.any():
                np.testing.assert_allclose(b[m], a[m], rtol=1e-4,
                                           atol=np.abs(a[m]).max() * 1e-5)


def _soup(dev, n_materials, seed=0):
    """The stand-in scene; with more than 17 materials its triangles get ids
    drawn over the whole table (most of them >= 256 for 300)."""
    tris = flatten_scene(random_soup_scene(234, seed=0, extent=90.0,
                                           tri_size=8.0), device=dev)
    if n_materials == 17:
        return tris, default_materials(dev)
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, n_materials, tris.pad_triangles),
                          device=dev)
    return (dataclasses.replace(tris, material=ids),
            checks.material_table(n_materials, rng, dev))


@pytest.mark.parametrize("parity,nrx,n_materials",
                         [("reference", 1, 17), ("physical", 3, 300)])
def test_fused_kernels_equal_plain(dev, parity, nrx, n_materials):
    tris, mats = _soup(dev, n_materials)
    with checks.recording_fused() as calls:
        _step(tris, nrx, mats, 1 << 16, True, parity=parity)
    assert [len(calls[n]) for n in checks.FUSED] == [3, 3, 1]
    for i, (args, out) in enumerate(calls["bounce_pre"]):
        checks.hold_pre(args[0], args[1:], out, f"pre{i}")
    for i, (args, out) in enumerate(calls["bounce_post"]):
        checks.hold_post(args[0], args[1:], out, f"post{i}")
    args, out = calls["loop_bwd_slim"][0]
    checks.hold_bwd(args[0], args[1:], out, mats, FREQ, "loop_bwd_slim")
    again = fused_ops.loop_bwd_slim(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_fused_step_matches_op_path(dev):
    tris, _ = _soup(dev, 17)
    nrx = 2
    grads, scat, launches = {}, {}, {}
    for shade in ("xla", "fused"):
        mats = default_materials(dev)
        for kern in checks.KERNELS.values():
            kern.launches = 0
        res, _ = _step(tris, nrx, mats, 1 << 14, shade == "fused")
        launches[shade] = {n: k.launches for n, k in checks.KERNELS.items()}
        grads[shade], scat[shade] = checks.grads_of(mats), res.scatter
    none = {n: 0 for n in checks.KERNELS}
    # the payload table's eta rows: one row gather
    assert launches["fused"] == {**none, "nearest_hit": 7, "bounce_pre": 3,
                                 "bounce_post": 3, "loop_bwd_slim": 1,
                                 "gather": 1}
    # the op path's fetches: the eta rows, per bounce the payload rows and
    # the occluder normals; the backward sums the first two per table row
    assert launches["xla"] == {**none, "nearest_hit": 7, "gather": 7,
                               "scatter_add": 4}
    checks.leaves_close(grads["fused"], grads["xla"], checks.PATH_GRAD_RTOL,
                        checks.LEAF_ATOL, "fused vs op path")
    for f in checks.OUTPUT_FIELDS:
        checks.slots_agree(getattr(scat["xla"], f), getattr(scat["fused"], f),
                           f)


def test_fused_kernels_reject_bad_operands(dev):
    spec = FusedSpec(nrx=1)
    R, T = 64, 128
    f = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                     device=dev)
    ok = dict(o=f(R, 3), d=f(R, 3), st=f(6, R),
              act=torch.ones(R, dtype=torch.bool, device=dev), idx=i32(R),
              table=f(T, 27), material=i32(T), rx_pos=f(1, 3), sc=f(2))
    fused_ops.bounce_pre(spec, *ok.values())
    torch.cuda.synchronize()
    for name, bad in (("idx", torch.zeros(R, dtype=torch.int64, device=dev)),
                      ("o", f(3, R).t()), ("table", f(T, 26)),
                      ("st", f(6, R).cpu()), ("material", i32(T).long())):
        with pytest.raises(ValueError):
            fused_ops.bounce_pre(spec, *{**ok, name: bad}.values())
    with pytest.raises(ValueError):
        fused_ops.loop_bwd_slim(
            spec, f(fused_ops.MAX_MATERIALS + 1, 12), f(2, 6, R),
            torch.ones((1, R), dtype=torch.bool, device=dev), i32(1, R),
            f(1, 3, R), f(1, 1, 6, R), f(1, 1, 6, R))


def _walk_scene(dev, ties=False):
    """6000 random triangles, Morton-sorted (48 fine tiles of 128); with
    ``ties`` 3000 and their exact copies in file order, so every hit is a
    tie with a triangle 3000 rows later, in another tile."""
    if ties:
        m = random_soup_scene(3000, seed=2, extent=60.0,
                              tri_size=3.0).meshes[0]
        idx = m.indices.astype(np.int64)
        host = HostScene([HostMesh(m.vertices, np.concatenate([idx, idx]),
                                   material_index=m.material_index)])
        return flatten_scene(host, device=dev)
    return flatten_scene(random_soup_scene(6000, seed=3, extent=60.0,
                                           tri_size=3.0),
                         sort_triangles=True, device=dev)


@pytest.mark.parametrize("opt", ["plain", "t_max_rays", "live", "all"])
def test_walk_prepass_kernel_equals_plain(dev, opt):
    rng = np.random.default_rng(11)
    tris = _walk_scene(dev)
    scene = prepare_walk(tris)
    R = (1 << 16) + 77
    o, d, kw = _inputs(rng, opt, R, tris.pad_triangles, dev)
    lim = query_limits(R, scene.block_rays, t_max=kw.get("t_max"),
                       live=kw.get("live"), device=dev)
    before = walk_prepass.launches
    visits = walk_prepass(o, d, lim, scene.boxes)
    torch.cuda.synchronize()
    assert walk_prepass.launches == before + 1
    r_p, k_p = prepass_plain(o, d, lim, scene.boxes, scene.block_rays)
    assert torch.equal(visits, visit_rows(r_p, k_p))


def _prepass_case(rng, R, C, share, dev, ties=False, inside=False):
    """Rays, padded limits and C boxes for the prepass: boxes of 1-30 m in
    a 100 m cube (with ``ties`` the second half a copy of the first, so
    equal keys tie across boxes), the last box the inverted padding box
    (+inf, -inf), which every live ray reaches at key 0; rays from a 120 m
    cube, every 9th along an axis (a zero direction component); with
    ``inside`` every origin inside box 0, so it and the padding box key
    +0.0.  ``share``: a live fraction, "one_a_tile" (one live ray in every
    tile of 256) or "banded" (the rays of every other run of 64); per-ray
    limits 5-200 m."""
    lo = rng.uniform(-50, 50, (C, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(1, 30, (C, 3))
                            .astype(np.float32)], axis=1)
    if ties and C > 1:
        boxes[C - C // 2:] = boxes[:C // 2]
    if C > 2:
        boxes[-1] = [np.inf] * 3 + [-np.inf] * 3
    o = rng.uniform(-60, 60, (R, 3)).astype(np.float32)
    if inside:
        o = boxes[0, :3] + rng.uniform(0.1, 0.9, (R, 3)).astype(
            np.float32) * (boxes[0, 3:] - boxes[0, :3])
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[::9, rng.integers(0, 3)] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = np.arange(R)
    if share == "one_a_tile":
        live = r % 256 == 37 % min(R, 256)
    elif share == "banded":
        live = (r // 64) % 2 == 0
    else:
        live = rng.uniform(size=R) < share
    t_max = rng.uniform(5, 200, R).astype(np.float32)
    lim = query_limits(R, 256, t_max=torch.as_tensor(t_max, device=dev),
                       live=torch.as_tensor(live, device=dev), device=dev)
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            lim, torch.as_tensor(boxes, device=dev))


@pytest.mark.parametrize("share", [0.0, "one_a_tile", 0.17, "banded", 1.0])
@pytest.mark.parametrize("R", [1, 255, 257, (1 << 16) + 37])
@pytest.mark.parametrize("C", [1, 7, 56, 256, 512])
def test_walk_prepass_rows_equal_plain(dev, C, R, share):
    """The prepass kernel's visit rows equal ``visit_rows(*prepass_plain)``
    bit for bit, the same in two runs; with ties across boxes and with
    +0.0 keys from rays that start inside a box."""
    rng = np.random.default_rng(C * 1000 + R % 1000)
    for ties, inside in ((False, False), (True, False), (True, True)):
        o, d, lim, boxes = _prepass_case(rng, R, C, share, dev, ties, inside)
        before = walk_prepass.launches
        v1 = walk_prepass(o, d, lim, boxes)
        v2 = walk_prepass(o, d, lim, boxes)
        torch.cuda.synchronize()
        assert walk_prepass.launches == before + 2
        assert torch.equal(v1, v2)
        ref = visit_rows(*prepass_plain(o, d, lim, boxes, 256))
        assert v1.shape == ref.shape == (lim.shape[0] // 256, 1 + C)
        assert torch.equal(v1, ref), (ties, inside)
        if share == 0.0:
            assert not bool(v1.any())
        elif C > 2 and share == 1.0:
            assert bool((v1[:, 0] > 0).all())   # the padding box at least


def test_walk_prepass_infinite_key(dev):
    """Under an infinite limit a box can be reached at key +inf, where it
    ties with the boxes no ray reaches: the rows still equal the plain
    version's stable sort.  Rays along x (inv y, z = 1e30) reach box 5,
    which is open to +inf in x and lies 1e9 away in y and z, at t_near =
    t_far = +inf; boxes 0-4 lie behind the rays, 6-9 ahead of them."""
    boxes = np.zeros((10, 6), np.float32)
    boxes[:5] = [-20, -1, -1, -10, 1, 1]
    boxes[5] = [1, 1e9, 1e9, np.inf, 2e9, 2e9]
    boxes[6:] = [[5 + 3 * i, -1, -1, 6 + 3 * i, 1, 1] for i in range(4)]
    R = 300
    o = np.zeros((R, 3), np.float32)
    d = np.tile(np.float32([1, 0, 0]), (R, 1))
    lim = query_limits(R, 256, t_max=float("inf"), device=dev)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    boxes = torch.as_tensor(boxes, device=dev)
    rows = walk_prepass(o, d, lim, boxes)
    reach, key = prepass_plain(o, d, lim, boxes, 256)
    assert bool(reach[:, 5].all()) and bool(torch.isinf(key[:, 5]).all())
    assert torch.equal(rows, visit_rows(reach, key))
    assert rows[0, 0] == 5     # 6-9 and 5


def test_walk_prepass_rejects_too_many_boxes(dev):
    rng = np.random.default_rng(3)
    o, d, lim, boxes = _prepass_case(rng, 300, 513, 1.0, dev)
    with pytest.raises(ValueError, match="MAX_BOXES = 512"):
        walk_prepass(o, d, lim, boxes)
    with pytest.raises(ValueError, match="MAX_BOXES = 512"):
        walk_prepass(o.cpu(), d.cpu(), lim.cpu(), boxes.cpu())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_walk_kernel_equals_plain_and_brute(dev, ties, any_hit):
    rng = np.random.default_rng(12)
    tris = _walk_scene(dev, ties)
    scene = prepare_walk(tris)
    R = (1 << 15) + 77
    o, d, kw = _inputs(rng, "all", R, tris.pad_triangles, dev)
    lim = query_limits(R, scene.block_rays, t_max=kw["t_max"],
                       live=kw["live"], device=dev)
    visits = walk_prepass(o, d, lim, scene.boxes)
    before = walk.launches
    t, i = walk(o, d, lim, scene, visits, exclude=kw["exclude"],
                any_hit=any_hit)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    # the plain walk on a sample of ray tiles (every 16th)
    tiles = torch.arange(0, visits.shape[0], 16, device=dev)
    rays = (tiles[:, None] * scene.block_rays
            + torch.arange(scene.block_rays, device=dev)).reshape(-1)
    rays = rays[rays < R]
    t_p, i_p = walk_plain(o[rays], d[rays], scene, visits[tiles],
                          lim.reshape(-1, scene.block_rays)[tiles].reshape(-1),
                          exclude=kw["exclude"][rays], any_hit=any_hit)
    assert torch.equal(i[rays], i_p) and torch.equal(t[rays], t_p)
    t_b, i_b = nearest_hit(o, d, tris, **kw)
    if not any_hit:
        assert torch.equal(i, i_b) and torch.equal(t, t_b)
    else:
        tm = kw["t_max"]
        blocked = (i >= 0) & (t <= tm)
        assert torch.equal(blocked, (i_b >= 0) & (t_b <= tm))
        sel = i[blocked].long()
        comp = lambda x: tuple(x[:, c] for c in range(3))  # noqa: E731
        t_re, valid = mt_hit(comp(o[blocked]), comp(d[blocked]),
                             comp(tris.v0[sel]), comp(tris.e1[sel]),
                             comp(tris.e2[sel]))
        assert bool(valid.all()) and torch.equal(t_re, t[blocked])
        assert not bool((sel == kw["exclude"][blocked].long()).any())
    if ties:
        # a copy wins only where its original is the ray's excluded one
        h = i_b >= 0
        hit, ex = i_b[h], kw["exclude"][h]
        assert hit.numel() and bool(((hit < 3000) | (ex == hit - 3000)).all())


def _tile_tie_scene(dev):
    """Ten blocks of 64 random triangles, each followed by its exact copy:
    every hit ties a triangle with its copy 64 rows later, in the same fine
    tile of 128 (another slice or lane of the kernel's deal)."""
    m = random_soup_scene(640, seed=5, extent=60.0, tri_size=3.0).meshes[0]
    idx = m.indices.astype(np.int64).reshape(10, 64, 3)
    idx = np.concatenate([idx, idx], axis=1).reshape(-1, 3)
    return flatten_scene(HostScene([HostMesh(
        m.vertices, idx, material_index=m.material_index)]), device=dev)


def _walk_inputs(rng, tris, R, share, any_hit, dev, coherent=False):
    """Rays, padded limits and exclude for a walk query of R rays with the
    given live share: a fraction, "one_a_tile" (one live ray in every tile
    of 256) or "every_7th".  Half the rays aim at a random triangle's
    centroid (the first four always), so most of those hit; ``coherent``
    rays start at one point, in launch order (neighbours in a tile are
    neighbours in direction).  Any-hit queries take a per-ray t_max (beyond
    the scene for coherent rays)."""
    T = tris.num_triangles
    cen = (tris.v0 + (tris.e1 + tris.e2) / 3.0)[:T].cpu().numpy()
    if coherent:
        o = np.broadcast_to(np.float32([5.0, -3.0, 20.0]), (R, 3)).copy()
    else:
        o = rng.uniform(-80, 80, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    aim = (rng.uniform(size=R) < 0.5) | (np.arange(R) < 4)
    d[aim] = cen[rng.integers(0, T, int(aim.sum()))] - o[aim]
    if coherent:
        d = d[np.lexsort((d[:, 1], np.sign(d[:, 2])))]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = np.arange(R)
    if share == "one_a_tile":
        live = r % 256 == 37 % min(R, 256)
    elif share == "every_7th":
        live = r % 7 == 0
    else:
        live = rng.uniform(size=R) < share
    lo, hi = (150, 250) if coherent else (0, 90)   # coherent: beyond all
    t_max = (torch.as_tensor(rng.uniform(lo, hi, R).astype(np.float32),
                             device=dev) if any_hit else None)
    lim = query_limits(R, 256, t_max=t_max,
                       live=torch.as_tensor(live, device=dev), device=dev)
    exclude = torch.as_tensor(rng.integers(-1, tris.pad_triangles, R)
                              .astype(np.int32), device=dev)
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            lim, exclude, int(live.sum()))


def _hold_walk(scene, o, d, lim, exclude, any_hit):
    """The walk kernel twice and its plain version once on every ray: the
    same bits in both runs and the plain version's bits.  Returns
    ``(t, idx)``."""
    visits = walk_prepass(o, d, lim, scene.boxes)
    before = walk.launches
    t1, i1 = walk(o, d, lim, scene, visits, exclude=exclude, any_hit=any_hit)
    t2, i2 = walk(o, d, lim, scene, visits, exclude=exclude, any_hit=any_hit)
    torch.cuda.synchronize()
    assert walk.launches == before + 2
    assert torch.equal(t1.view(torch.int32), t2.view(torch.int32))
    assert torch.equal(i1, i2)
    t_p, i_p = walk_plain(o, d, scene, visits, lim, exclude=exclude,
                          any_hit=any_hit)
    assert torch.equal(i1, i_p)
    assert torch.equal(t1.view(torch.int32), t_p.view(torch.int32))
    return t1, i1


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("share", [0.0, "one_a_tile", "every_7th", 0.17, 0.36,
                                   0.52, 1.0])
def test_walk_kernel_live_shares(dev, share, any_hit):
    rng = np.random.default_rng(21)
    tris = _walk_scene(dev)
    scene = prepare_walk(tris)
    o, d, lim, ex, n_live = _walk_inputs(rng, tris, (1 << 16) + 37, share,
                                         any_hit, dev)
    t, i = _hold_walk(scene, o, d, lim, ex, any_hit)
    dead = (lim[:o.shape[0]] < 0)
    assert bool((i[dead] == -1).all()) and bool(torch.isinf(t[dead]).all())
    assert (n_live == 0) == (not bool((i >= 0).any()))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("R", [1, 4, 255, 257, (1 << 16) + 37])
def test_walk_kernel_ray_counts(dev, R, any_hit):
    rng = np.random.default_rng(22)
    tris = _walk_scene(dev)
    scene = prepare_walk(tris)
    o, d, lim, ex, _ = _walk_inputs(rng, tris, R, 1.0, any_hit, dev,
                                    coherent=True)
    _, i = _hold_walk(scene, o, d, lim, ex, any_hit)
    assert bool((i >= 0).any())


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("block_tris", [64, 128, 256])
def test_walk_kernel_tile_sizes(dev, block_tris, group):
    rng = np.random.default_rng(23)
    tris = _walk_scene(dev)
    scene = prepare_walk(tris, block_tris=block_tris, group=group)
    assert (scene.block_tris, scene.group) == (block_tris, group)
    for any_hit, coherent in ((False, False), (True, True)):
        o, d, lim, ex, _ = _walk_inputs(rng, tris, 20000, 0.36, any_hit, dev,
                                        coherent=coherent)
        _, i = _hold_walk(scene, o, d, lim, ex, any_hit)
        assert bool((i >= 0).any())


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_kernel_ties(dev, any_hit):
    rng = np.random.default_rng(24)
    for tris, copy in ((_walk_scene(dev, ties=True), 3000),
                       (_tile_tie_scene(dev), 64)):
        scene = prepare_walk(tris)
        o, d, lim, ex, _ = _walk_inputs(rng, tris, 30000, 0.52, any_hit, dev)
        t, i = _hold_walk(scene, o, d, lim, ex, any_hit)
        if any_hit and copy == 3000:
            continue   # the copy's tile may come first and end the search
        # an original wins its tie unless it is the ray's excluded triangle
        h = i >= 0
        orig = (i[h] // copy) % 2 == 0 if copy == 64 else i[h] < copy
        assert h.any() and bool((orig | (ex[h] == i[h] - copy)).all())


def test_walk_rejects_bad_operands(dev):
    tris = _walk_scene(dev)
    scene = prepare_walk(tris)
    o = torch.zeros((8, 3), device=dev)
    d = torch.ones((8, 3), device=dev)
    lim = query_limits(8, scene.block_rays, device=dev)
    visits = walk_prepass(o, d, lim, scene.boxes)
    with pytest.raises(ValueError):
        walk_prepass(o.double(), d, lim, scene.boxes)
    with pytest.raises(ValueError):
        walk_prepass(o, d, lim, scene.boxes, block_rays=128)
    with pytest.raises(ValueError):
        walk(o, d, lim, scene, visits.long())
    with pytest.raises(ValueError):
        walk(o, d, lim.cpu(), scene, visits)
    with pytest.raises(ValueError):
        walk(o, d, lim, scene, visits,
             exclude=torch.zeros(8, dtype=torch.int64, device=dev))
    shifted = torch.zeros(scene.records.numel() + 1, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        walk(o, d, lim, dataclasses.replace(
            scene, records=shifted.view(scene.records.shape)), visits)


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_trace_through_walk_equals_brute(dev, parity):
    rx = np.array([[10.0, 5.0, 2.0], [11.5, 3.0, 2.25]], np.float32)
    tx = np.array([[-20.0, -10.0, 10.0]], np.float32)
    z = np.zeros((2, 3))
    tris = _walk_scene(dev)
    out = {}
    for w in (False, True):
        counts = (nearest_hit.launches, walk.launches, walk_prepass.launches)
        out[w] = compute_paths(tris, rx, tx, z, z[:1], 3.0, 2, 1, 1 << 14, 3,
                               device=dev, parity=parity, walk=w,
                               compact_rays=True, keep_rays=False)
        launched = (nearest_hit.launches - counts[0],
                    walk.launches - counts[1],
                    walk_prepass.launches - counts[2])
        assert launched == ((0, 7, 7) if w else (7, 0, 0))
    for part in (0, 1):
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
            assert torch.equal(getattr(out[False][part], f),
                               getattr(out[True][part], f)), (part, f)


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """The box city (``make_city``'s defaults, 131,072 triangles,
    Morton-sorted) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return flatten_scene(load_scene(make_city(str(
        tmp_path_factory.mktemp("city")))), sort_triangles=True,
        device=torch.device("cuda"))


_PITCH = 2 * 400.0 * 0.9 / 13          # the street grid of 13 x 13 lots
CITY_RX = np.array([[-360.0 + i * _PITCH, -360.0 + j * _PITCH, 1.5]
                    for i, j in ((3, 5), (6, 6), (9, 4), (4, 10))],
                   np.float32)
CITY_TX = np.array([[-120.0, 80.0, 45.0]], np.float32)


def _city_drop(tris, **kw):
    """``compute_paths`` at the box-city forward cell's shape: 2^20
    coherent paths, 3 bounces, 4 RX at 1.5 m in the streets, rooftop TX,
    physical parity; ``kw`` over the port's defaults.  Returns ``(los,
    scatter)`` and the growth of every counter."""
    z = np.zeros((4, 3), np.float32)
    c0 = dict(profiling.COUNTERS)
    out = compute_paths(tris, CITY_RX, CITY_TX, z, z[:1], 3.0, 4, 1, 1 << 20,
                        3, device=tris.device, parity="physical", **kw)
    torch.cuda.synchronize()
    return out, {k: v - c0.get(k, 0) for k, v in profiling.COUNTERS.items()
                 if v != c0.get(k, 0)}


def test_city_default_mask_gives_the_unmasked_bits(city):
    """The box city at the box-city forward cell's shape.  The default,
    whose bounce and shadow queries walk only live rays, gives
    ``compact_rays=False``'s bits."""
    out = []
    for kw in ({}, dict(compact_rays=False)):
        drop, grew = _city_drop(city, **kw)
        out.append(drop)
        grew = [grew.get(k, 0) for k in ("queries", "queries.masked")]
        assert grew == [7, 6 if not kw else 0], grew
    written = out[0][1].a_te.abs() > 0
    assert written.any() and not written.all()
    for part in (0, 1):
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
            assert torch.equal(getattr(out[0][part], f),
                               getattr(out[1][part], f)), (part, f)


def _as_rows(x):
    """An output ``[nrx, ntx, K(, 3)]`` as f32 row groups ``[n, g, K]``,
    paths last: a complex one's (re, im) a group of two rows, a vector's
    components a group of three."""
    if x.is_complex():
        x = torch.stack([x.real, x.imag], dim=-2)
    elif x.ndim == 4:
        x = x.movedim(-1, -2)
    else:
        x = x.unsqueeze(-2)
    return x.reshape(-1, x.shape[-2], x.shape[-1])


def test_city_default_drop_runs_the_fused_forward(city):
    """The default drop (``shade="auto"``, under ``compute_paths``'s
    ``no_grad``) against ``shade="xla"``: the fused forward's two kernels a
    bounce, one ``trace.fused``, no backward kernel and no payload fetch
    but the eta rows'; the written slots (the decisions) identical, every
    value within the fused forward's tier (ROW_RTOL of its row's largest,
    (re, im) and a vector's components as one row group)."""
    out, grew = _city_drop(city)
    want, grew_x = _city_drop(city, shade="xla")
    launched = {k[len("launches."):]: v for k, v in grew.items()
                if k.startswith("launches.")}
    assert launched == {"walk_prepass": 7, "walk": 7, "bounce_pre": 3,
                        "bounce_post": 3, "gather": 1}, launched
    assert grew.get("trace.fused") == 1 and "trace.op" not in grew
    assert grew_x.get("trace.op") == 1 and "trace.fused" not in grew_x
    for part in (0, 1):
        for f in checks.OUTPUT_FIELDS:
            a, b = getattr(out[part], f), getattr(want[part], f)
            written = (lambda x: (x.abs() > 0).any(-1) if x.ndim == 4
                       else x.abs() > 0)
            assert torch.equal(written(a), written(b)), (part, f)
            a, b = _as_rows(a), _as_rows(b)
            checks.rows_close(a, b, checks.ROW_RTOL, f"{part} {f}",
                              (tuple(range(a.shape[1])),))
    assert (out[1].a_te.abs() > 0).any()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O2I_CELL = "umi_o2i131k.fwd.nrx5"
O2I_PATHS = 1 << 20


@pytest.fixture(scope="module")
def o2i(tmp_path_factory):
    """The O2I cell's deployment on the card: its scene (the box city of
    closed concrete boxes, built by the benchmark's generator and read as
    the cell reads it), TX, frequency and flags, and one drop of 5 RX
    drawn by its entry (4 indoor, 1 outdoor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    sys.path.insert(0, REPO)
    from rtbench import harness
    rt = os.path.join(REPO, "rtbench")
    cfg = harness.load_json(os.path.join(rt, "configs", "umi_o2i131k.json"))
    wl = harness.load_json(os.path.join(rt, "workloads",
                                        f"{O2I_CELL}.json"))
    entry = harness.load_module(os.path.join(rt, "entries", "forward_o2i.py"),
                                "rtbench_entry_forward_o2i")
    gen = harness.load_module(os.path.join(rt, "scenes", "city.py"),
                              "rtbench_scene_city")
    out = gen.generate(cfg["scene"], str(tmp_path_factory.mktemp("o2i")))
    tx = np.asarray(cfg["tracer"]["tx"], np.float32)
    boxes = entry.building_boxes(out["meshes"], cfg["scene"]["n_buildings"])
    rx = entry.draw_drops(wl["traffic_params"], boxes, 1,
                          np.random.default_rng(2718281828), tx)[0]
    t = cfg["tracer"]
    return SimpleNamespace(
        scene=load_scene(out["file"]), rx=rx, tx=tx,
        f_ghz=float(t["frequency_ghz"]),
        flags={k: t[k] for k in ("parity", "transmission",
                                 "spawn_transmission", "refraction")})


def _o2i_drop(o2i, tris, **kw):
    """One O2I drop (2^20 paths, 3 bounces) with ``kw`` over the cell's
    flags; ``(los, scatter)`` and the growth of every counter."""
    c0 = dict(profiling.COUNTERS)
    out = compute_paths(tris, o2i.rx, o2i.tx[None], None, None, o2i.f_ghz,
                        len(o2i.rx), 1, O2I_PATHS, 3, device=tris.device,
                        **{**o2i.flags, **kw})
    torch.cuda.synchronize()
    return out, {k: v - c0.get(k, 0) for k, v in profiling.COUNTERS.items()
                 if v != c0.get(k, 0)}


@pytest.fixture(scope="module")
def o2i_tris(o2i):
    return flatten_scene(o2i.scene, sort_triangles=True,
                         device=torch.device("cuda"))


# the transmission modes the fused forward takes (straight refraction), as
# tests/test_torch_transmission.py's FORWARD_MODES: each runs its own
# instantiations (pre <0> / <2>, post <1> / <2> / <3>)
O2I_MODES = {"transmission": dict(spawn_transmission=False),
             "spawn_straight": dict(transmission=False),
             "both": {}}


@pytest.mark.parametrize("mode", sorted(O2I_MODES))
def test_o2i_fused_kernels_equal_plain(o2i, o2i_tris, mode):
    """Each launch of the fused forward in an O2I drop (5 RX, 2^20 rays)
    under each transmission mode against its plain version on the same
    operands: decisions equal, values within ``checks.ROW_RTOL``."""
    with checks.recording_fused() as calls:
        _o2i_drop(o2i, o2i_tris, **O2I_MODES[mode])
    assert [len(calls[n]) for n in checks.FUSED] == [3, 3, 0]
    want = {**o2i.flags, **O2I_MODES[mode]}
    for i, (args, out) in enumerate(calls["bounce_pre"]):
        spec = args[0]
        assert (spec.transmission, spec.spawn_transmission, spec.nrx) == (
            want["transmission"], want["spawn_transmission"], 5)
        checks.hold_pre(spec, args[1:], out, f"{mode} pre{i}")
    for i, (args, out) in enumerate(calls["bounce_post"]):
        checks.hold_post(args[0], args[1:], out, f"{mode} post{i}")
    if want["transmission"]:
        # blocked (ray, RX) pairs are written: an indoor RX sees paths
        assert bool(calls["bounce_post"][0][1].write[:4].any())


def test_city_o2i_drop_default_runs_the_fused_forward(o2i, o2i_tris):
    """The O2I drop with the default shade runs the fused forward: two
    kernels a bounce, the row gather only for the eta rows and the LoS
    blockers (the only blocker rows counted), one ``trace.fused``, no
    warning; against ``shade="xla"`` (the op path) the
    written slots identical, every value within the fused tier, and no
    sampled entry beyond the benchmark's tolerances (``path_mismatch``
    0).  With ``refraction="snell"`` the default stays on the op path."""
    from rtbench import compare
    from rtbench.check import program_sample
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, grew = _o2i_drop(o2i, o2i_tris)
    want, grew_x = _o2i_drop(o2i, o2i_tris, shade="xla")
    nrx, R = len(o2i.rx), O2I_PATHS
    queries = 1 + 3 * (1 + nrx // tracer_module.rx_rows_per_query(
        nrx, R, TracerConfig().rx_query_rays))
    launched = {k[len("launches."):]: v for k, v in grew.items()
                if k.startswith("launches.")}
    assert launched == {"walk_prepass": queries, "walk": queries,
                        "bounce_pre": 3, "bounce_post": 3, "gather": 2}, \
        launched
    assert grew.get("trace.fused") == 1 and "trace.op" not in grew
    assert grew_x.get("trace.op") == 1 and "trace.fused" not in grew_x
    # the post kernel reads its blockers from the payload table: only the
    # LoS pass gathers blocker rows
    assert grew["transmit.blocker_rows"] == nrx
    assert grew_x["transmit.blocker_rows"] == nrx + 3 * nrx * R
    for part in (0, 1):
        for f in checks.OUTPUT_FIELDS:
            a, b = getattr(out[part], f), getattr(want[part], f)
            written = (lambda x: (x.abs() > 0).any(-1) if x.ndim == 4
                       else x.abs() > 0)
            assert torch.equal(written(a), written(b)), (part, f)
            a, b = _as_rows(a), _as_rows(b)
            checks.rows_close(a, b, checks.ROW_RTOL, f"{part} {f}",
                              (tuple(range(a.shape[1])),))
    ids = torch.arange(0, O2I_PATHS, 64)
    bad, live = compare.mismatch_counts(
        program_sample(*out, ids, 3, O2I_PATHS),
        program_sample(*want, ids, 3, O2I_PATHS))
    assert bad == 0 and live > 1000, (bad, live)
    _, grew_s = _o2i_drop(o2i, o2i_tris, refraction="snell")
    assert grew_s.get("trace.op") == 1 and "trace.fused" not in grew_s
    assert not any(k.startswith("launches.bounce_") for k in grew_s)


def _grad_step(dev, tris, nrx, paths, parity, **kw):
    """One full-gradient step (tests/test_bounce_fused.py's loss) with
    gradients to the materials, RX and TX positions, the frequency and the
    vertices.  Returns the gradients by leaf."""
    mats = default_materials(dev)
    v0 = tris.v0.clone().requires_grad_()
    leaves = dict(rx=torch.tensor(RX[:nrx], device=dev, requires_grad=True),
                  tx=torch.tensor(TX, device=dev, requires_grad=True),
                  f=torch.tensor(FREQ, device=dev, requires_grad=True))
    cfg = TracerConfig(num_paths=paths, num_bounces=3, parity=parity,
                       keep_rays=False, compact_rays=True, **kw)
    res = trace_paths(dataclasses.replace(tris, v0=v0), mats, leaves["rx"],
                      leaves["tx"], np.zeros((nrx, 3), np.float32),
                      np.zeros((1, 3), np.float32), leaves["f"], cfg)
    checks.grad_loss(res).backward()
    torch.cuda.synchronize()
    return {**checks.grads_of(mats), "v0": v0.grad,
            **{k: x.grad for k, x in leaves.items()}}


def _moving_soup(dev):
    tris, _ = _soup(dev, 17)
    vel = np.random.default_rng(4).uniform(-2, 2, (tris.pad_triangles, 3))
    return dataclasses.replace(tris, velocity=torch.as_tensor(
        vel.astype(np.float32), device=dev))


@pytest.mark.parametrize("parity,nrx,grad_geometry", [
    ("reference", 3, True), ("physical", 1, False)])
def test_stage_backward_kernels_equal_plain(dev, parity, nrx, grad_geometry):
    tris = _moving_soup(dev)
    with checks.recording_fused() as calls:
        _grad_step(dev, tris, nrx, 1 << 14, parity, shade="fused",
                   grad_geometry=grad_geometry)
    assert [len(calls[n]) for n in ("bounce_pre_bwd", "bounce_post_bwd",
                                    "bounce_pre_bwd_slim")] == [3, 3, 0]
    for name, hold in (("bounce_pre_bwd", checks.hold_pre_bwd),
                       ("bounce_post_bwd", checks.hold_post_bwd)):
        for i, (args, out) in enumerate(calls[name]):
            hold(args[0], args[1:], out, f"{name}{i}")
            again = checks.KERNELS[name](*args)
            assert all(a is None or torch.equal(a, b)
                       for a, b in zip(out, again))
    # per bounce the pre and post rows (and the occluder normals), then the
    # table's eta rows per material
    n_scatter = 3 * (2 + (grad_geometry and parity == "reference")) + 1
    assert len(calls["scatter_add"]) == n_scatter
    for i, (args, _) in enumerate(calls["scatter_add"]):
        checks.hold_scatter_add(*args, f"scatter_add{i}")


def _rx(nrx):
    """nrx receivers: (10, 5, 2) + k (1.5, -2, 0.25)."""
    return RX[:1] + np.arange(nrx, dtype=np.float32)[:, None] * np.float32(
        [[1.5, -2.0, 0.25]])


def _first_rays(args, R):
    """A recorded full pre backward call's operands cut to its first R
    rays (contiguous copies)."""
    (spec, o, d, st, act, idx, table, rx_pos, sc, d_o2, d_d2, d_st2, d_ex,
     d_sh_d, d_d2rx) = args
    rows = [x[:R].contiguous() for x in (o, d, act, idx, d_o2, d_d2)]
    cols = [x[:, :R].contiguous() for x in (st, d_st2, d_ex, d_sh_d, d_d2rx)]
    return (spec, rows[0], rows[1], cols[0], rows[2], rows[3], table, rx_pos,
            sc, rows[4], rows[5], cols[1], cols[2], cols[3], cols[4])


@pytest.mark.parametrize("grad_geometry", [True, False])
@pytest.mark.parametrize("parity", ["reference", "physical"])
@pytest.mark.parametrize("nrx", [1, 2, 4, 8, 16])
def test_pre_bwd_kernel_shapes(dev, nrx, parity, grad_geometry):
    """The full pre backward on a full-gradient step's recorded operands
    (the 300-row material table, ids over all of it), cut to R = 1, 257 and
    2^16 + 37 rays and whole: within ``hold_pre_bwd``'s tiers, the same bits
    in two runs; pc 27 with ``grad_geometry``, else 12."""
    tris, mats = _soup(dev, 300)
    v0 = tris.v0.clone().requires_grad_()
    rx = torch.tensor(_rx(nrx), device=dev, requires_grad=True)
    f = torch.tensor(FREQ, device=dev, requires_grad=True)
    cfg = TracerConfig(num_paths=1 << 17, num_bounces=3, parity=parity,
                       keep_rays=False, compact_rays=True, shade="fused",
                       grad_geometry=grad_geometry)
    with checks.recording_fused() as calls:
        res = trace_paths(dataclasses.replace(tris, v0=v0), mats, rx, TX,
                          np.zeros((nrx, 3), np.float32),
                          np.zeros((1, 3), np.float32), f, cfg)
        checks.grad_loss(res).backward()
        torch.cuda.synchronize()
    assert len(calls["bounce_pre_bwd"]) == 3
    args, out = max(calls["bounce_pre_bwd"], key=lambda c: c[0][1].shape[0])
    assert out[3].shape[1] == (27 if grad_geometry else 12)
    assert args[1].shape[0] >= (1 << 16) + 37
    for R in (1, 257, (1 << 16) + 37, args[1].shape[0]):
        a = _first_rays(args, R)
        k1 = fused_ops.bounce_pre_bwd(*a)
        k2 = fused_ops.bounce_pre_bwd(*a)
        assert all(torch.equal(x, y) for x, y in zip(k1, k2)), R
        checks.hold_pre_bwd(a[0], a[1:], k1, f"pre_bwd nrx {nrx} R {R}")


def _first_post_rays(args, R):
    """A recorded full post backward call's operands cut to its first R
    rays (contiguous copies)."""
    (spec, d2, st2, ex, sh_d, d2rx, t_self, crossing, excl, live, t_o, idx_o,
     table, sc, d_out) = args
    cut = [x[..., :R].contiguous() for x in (st2, ex, d2rx, t_self, crossing,
                                             t_o, idx_o, d_out)]
    st2, ex, d2rx, t_self, crossing, t_o, idx_o, d_out = cut
    return (spec, d2[:R].contiguous(), st2, ex, sh_d[:, :R].contiguous(),
            d2rx, t_self, crossing, excl[:R].contiguous(),
            live[:R].contiguous(), t_o, idx_o, table, sc, d_out)


@pytest.mark.parametrize("grad_geometry", [True, False])
@pytest.mark.parametrize("parity", ["reference", "physical"])
@pytest.mark.parametrize("nrx", [1, 2, 4, 8, 16])
def test_post_bwd_kernel_shapes(dev, nrx, parity, grad_geometry):
    """The full post backward on a full-gradient step's recorded operands
    (the 300-row material table, ids over all of it), cut to R = 1, 257 and
    2^16 + 37 rays (RX rows that start off 16 bytes) and whole: within
    ``hold_post_bwd``'s tiers, the same bits in three runs in a row (the
    kernel's count of finished blocks goes back to 0); pc 27 and the
    occluder rows (reference parity) with ``grad_geometry``, else pc 2 and
    none."""
    tris, mats = _soup(dev, 300)
    v0 = tris.v0.clone().requires_grad_()
    rx = torch.tensor(_rx(nrx), device=dev, requires_grad=True)
    f = torch.tensor(FREQ, device=dev, requires_grad=True)
    cfg = TracerConfig(num_paths=1 << 17, num_bounces=3, parity=parity,
                       keep_rays=False, compact_rays=True, shade="fused",
                       grad_geometry=grad_geometry)
    with checks.recording_fused() as calls:
        res = trace_paths(dataclasses.replace(tris, v0=v0), mats, rx, TX,
                          np.zeros((nrx, 3), np.float32),
                          np.zeros((1, 3), np.float32), f, cfg)
        checks.grad_loss(res).backward()
        torch.cuda.synchronize()
    assert len(calls["bounce_post_bwd"]) == 3
    args, out = max(calls["bounce_post_bwd"], key=lambda c: c[0][1].shape[0])
    assert out[5].shape[1] == (27 if grad_geometry else 2)
    assert (out[7] is not None) == (grad_geometry and parity == "reference")
    assert args[1].shape[0] >= (1 << 16) + 37
    for R in (1, 257, (1 << 16) + 37, args[1].shape[0]):
        a = _first_post_rays(args, R)
        runs = [fused_ops.bounce_post_bwd(*a) for _ in range(3)]
        for k in runs[1:]:
            assert all(x is None or torch.equal(x, y)
                       for x, y in zip(runs[0], k)), R
        checks.hold_post_bwd(a[0], a[1:], runs[0],
                             f"post_bwd nrx {nrx} {parity} R {R}")


def _first_loop_rays(args, R):
    """A recorded whole-loop backward call's operands cut to its first R
    rays (contiguous copies)."""
    return (args[0], args[1], *(x[..., :R].contiguous() for x in args[2:]))


@pytest.mark.parametrize("bounces", [1, 3])
@pytest.mark.parametrize("M", [1, 17, 300])
def test_loop_bwd_kernel_shapes(dev, M, bounces):
    """The whole-loop backward on a calibration step's recorded operands at
    B bounces, its table replaced by M materials with ids drawn over all of
    them (warps of up to 32 materials), cut to R = 1, 257 and 2^16 + 37
    rays and whole: within ``hold_bwd``'s tiers, the same bits in three
    runs in a row."""
    tris, mats17 = _soup(dev, 17)
    cfg = checks.calibration_config(1 << 17, bounces, True)
    with checks.recording_fused() as calls:
        checks.calibration_step(tris, RX[:2], TX, FREQ, mats17, cfg)
    args, _ = calls["loop_bwd_slim"][0]
    rng = np.random.default_rng(M + bounces)
    mats = checks.material_table(M, rng, dev)
    eta = precompute_eta(mats, FREQ)
    eta_tab = torch.stack([getattr(eta, f) for f in ETA_FIELDS],
                          dim=-1).detach()
    mat_all = torch.as_tensor(rng.integers(0, M, args[4].shape),
                              dtype=torch.int32, device=dev)
    args = (args[0], eta_tab, args[2], args[3], mat_all, *args[5:])
    assert args[2].shape[0] == bounces + 1
    assert args[2].shape[-1] >= (1 << 16) + 37
    for R in (1, 257, (1 << 16) + 37, args[2].shape[-1]):
        a = _first_loop_rays(args, R)
        runs = [fused_ops.loop_bwd_slim(*a) for _ in range(3)]
        for k in runs[1:]:
            assert all(torch.equal(x, y) for x, y in zip(runs[0], k)), R
        checks.hold_bwd(a[0], a[1:], runs[0], mats, FREQ,
                        f"loop_bwd M {M} B {bounces} R {R}")


def test_other_bwd_kernels_same_bits_twice(dev):
    """Kernels 13-16 on their first recorded call in small seeded steps
    (the full post backward in a full-gradient step, the slim ones with
    ``unroll_bounces=False``, the whole-loop one in the calibration step):
    a second run gives the same bits, and each is held against its plain
    version.  That they keep their bits across a change of the other
    kernels is ``scripts/profile_op_steps.py --steps bwd``'s comparison of
    two trees."""
    tris = _moving_soup(dev)
    mats = {u: default_materials(dev) for u in (False, True)}
    with checks.recording_fused() as calls:
        _grad_step(dev, tris, 2, 1 << 12, "reference", shade="fused")
        _step(tris, 2, mats[False], 1 << 12, True, unroll_bounces=False)
        _step(tris, 2, mats[True], 1 << 12, True)
    holds = {"bounce_post_bwd": checks.hold_post_bwd,
             "bounce_pre_bwd_slim": checks.hold_pre_bwd_slim,
             "bounce_post_bwd_slim": checks.hold_post_bwd_slim,
             "loop_bwd_slim": lambda spec, rest, out, label: checks.hold_bwd(
                 spec, rest, out, mats[True], FREQ, label)}
    for name, hold in holds.items():
        args, out = calls[name][0]
        again = checks.KERNELS[name](*args)
        assert all(a is None or torch.equal(a, b)
                   for a, b in zip(out, again)), name
        hold(args[0], args[1:], out, name)


def test_slim_stage_kernels_equal_plain(dev):
    tris, mats = _soup(dev, 17)
    with checks.recording_fused() as calls:
        _step(tris, 2, mats, 1 << 14, True, unroll_bounces=False)
    assert [len(calls[n]) for n in ("bounce_pre_bwd_slim",
                                    "bounce_post_bwd_slim", "loop_bwd_slim",
                                    "scatter_add")] == [3, 3, 0, 7]
    for name, hold in (("bounce_pre_bwd_slim", checks.hold_pre_bwd_slim),
                       ("bounce_post_bwd_slim", checks.hold_post_bwd_slim)):
        for i, (args, out) in enumerate(calls[name]):
            hold(args[0], args[1:], out, f"{name}{i}")
    for i, (args, _) in enumerate(calls["scatter_add"]):
        checks.hold_scatter_add(*args, f"scatter_add{i}")


def _slim_table(dev):
    """A 256-row payload table: seeded geometry, and the eta rows of a
    300-row material table at ids drawn over all of it."""
    rng = np.random.default_rng(0)
    eta = precompute_eta(checks.material_table(300, rng, dev), FREQ)
    eta_tab = torch.stack([getattr(eta, f) for f in ETA_FIELDS],
                          dim=-1).detach()
    ids = torch.as_tensor(rng.integers(0, 300, 256), device=dev)
    geo = torch.as_tensor(rng.normal(size=(256, 15)).astype(np.float32),
                          device=dev)
    return torch.cat([geo, eta_tab[ids]], dim=-1).contiguous()


@pytest.mark.parametrize("live", measure.SLIM_LIVE)
@pytest.mark.parametrize("R", [1 << 20, (1 << 16) + 77, 33, 1])
def test_pre_bwd_slim_kernel_live_shares(dev, R, live):
    """Kernel 14 on seeded operands (``measure.pre_bwd_slim_operands``:
    every ray live, ~17% clustered, ~1% scattered, none; R with a tail
    warp): within ``hold_pre_bwd_slim``'s tiers, a dead ray's outputs the
    plain version's bits (its state cotangent copied, a zero eta row), the
    same bits in two runs; ``d_st`` is the plain version's bits on every
    ray (a live ray's is four products and sums, done in the same order).
    That every per-ray output is the parent design's bits is
    ``scripts/profile_op_steps.py --steps bwd``'s comparison of two trees
    on these operands."""
    spec = FusedSpec(nrx=1, grad_positions=False, grad_geometry=False)
    ops = measure.pre_bwd_slim_operands(R, live, _slim_table(dev), seed=R)
    k1 = fused_ops.bounce_pre_bwd_slim(spec, *ops)
    k2 = fused_ops.bounce_pre_bwd_slim(spec, *ops)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    p = bounce_pre_bwd_slim_plain(spec, *ops)
    dead = ~(ops[1] & (ops[2] >= 0))
    assert torch.equal(k1[0], p[0])
    assert torch.equal(k1[1][dead], p[1][dead])
    checks.hold_pre_bwd_slim(spec, ops, k1, f"pre_bwd_slim R {R} {live}")


def test_large_table_step_takes_stage_kernels(dev):
    """A calibration step on a 5,000-row material table (ids over all of
    it) under the default ``unroll_bounces``: past ``MAX_MATERIALS`` it runs
    the per-stage kernels and never the whole-loop backward, each slim
    backward within its tier, and its material gradients hold against the
    op path's."""
    tris, _ = _soup(dev, 5000)
    grads = {}
    for fused in (False, True):
        mats = checks.material_table(5000, np.random.default_rng(1), dev)
        with checks.recording_fused() as calls:
            _step(tris, 2, mats, 1 << 14, fused)
        grads[fused] = checks.grads_of(mats)
    assert [len(calls[n]) for n in ("bounce_pre_bwd_slim",
                                    "bounce_post_bwd_slim", "loop_bwd_slim",
                                    "scatter_add")] == [3, 3, 0, 7]
    for name, hold in (("bounce_pre_bwd_slim", checks.hold_pre_bwd_slim),
                       ("bounce_post_bwd_slim", checks.hold_post_bwd_slim)):
        for i, (args, out) in enumerate(calls[name]):
            hold(args[0], args[1:], out, f"{name}{i}")
    assert float(grads[True]["a"][fused_ops.MAX_MATERIALS:].abs().max()) > 0
    checks.leaves_close(grads[True], grads[False], checks.PATH_GRAD_RTOL,
                        checks.LEAF_ATOL, "5,000 materials")


@pytest.mark.parametrize("C", [27, 12, 2, 3])
def test_scatter_add_kernel_equals_plain(dev, C):
    rng = np.random.default_rng(C)
    T, N = 1000, (1 << 16) + 77
    idx = rng.integers(-5, T + 5, N).astype(np.int32)   # drops both ends
    idx[rng.uniform(size=N) < 0.3] = 17                  # a long run
    g = torch.as_tensor(rng.normal(size=(N, C)).astype(np.float32),
                        device=dev)
    idx = torch.as_tensor(idx, device=dev)
    before = scatter_add.launches
    err, rows = checks.hold_scatter_add(idx, g, T, f"C={C}")
    assert scatter_add.launches == before + 2 and rows > 0
    out = torch.ones((T, 30), device=dev)
    scatter_add(idx, g, T, out=out, col=30 - C)
    torch.cuda.synchronize()
    want = torch.ones((T, 30), device=dev)
    want[:, 30 - C:] += scatter_add(idx, g, T)
    assert torch.equal(out, want)


@pytest.mark.parametrize("T,C", [(256, 27), (256, 12), (256, 3), (300, 12)])
def test_scatter_add_dense_route_equals_ordered_plain(dev, T, C):
    """The dense route (the canyon's windows, a 300-row material table)
    adds in the grouping of ``scatter_add_ordered_plain``: the same bits."""
    rng = np.random.default_rng(T + C)
    N = (1 << 16) + 77
    idx = rng.integers(-5, T + 5, N).astype(np.int32)   # drops both ends
    idx[rng.uniform(size=N) < 0.3] = 17                  # a long run
    g = torch.as_tensor((rng.normal(size=(N, C)) * 10.0 ** rng.integers(
        -6, 6, (N, C))).astype(np.float32), device=dev)
    idx = torch.as_tensor(idx, device=dev)
    assert scatter_add.route(T, C, dev) == "dense"
    before = scatter_add.launches
    k = scatter_add(idx, g, T)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    assert torch.equal(k, scatter_add_ordered_plain(idx, g, T))
    checks.hold_scatter_add(idx, g, T, f"dense T={T} C={C}")


@pytest.mark.parametrize("T", [256, 131072])
def test_scatter_add_reads_a_column_window(dev, T):
    """g as a column window of a wider tensor (read through its leading
    dimension, both routes) sums as the copied window does."""
    rng = np.random.default_rng(T)
    N = (1 << 16) + 77
    idx = torch.as_tensor(rng.integers(-1, T, N).astype(np.int32),
                          device=dev)
    full = torch.as_tensor(rng.normal(size=(N, 40)).astype(np.float32),
                           device=dev)
    window = full[:, 13:25]
    assert not window.is_contiguous()
    out = torch.ones((T, 27), device=dev)
    scatter_add(idx, window, T, out=out, col=15)
    want = torch.ones((T, 27), device=dev)
    scatter_add(idx, window.contiguous(), T, out=want, col=15)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    with pytest.raises(ValueError):         # rows that are not unit-stride
        scatter_add(idx, torch.ones((1, 12), device=dev).expand(N, 12), T)


def test_gather_kernel_zero_rows_and_tail(dev):
    """Ids outside ``[0, T)`` give rows of zeros, staged (256 rows) and
    from L2 (2,000 rows); a tail of 13 rows after one whole group."""
    rng = np.random.default_rng(5)
    for T in (256, 2000):
        table = torch.as_tensor(rng.normal(size=(T, 27)).astype(np.float32),
                                device=dev)
        ids = rng.integers(0, T, 45).astype(np.int32)
        ids[[0, 9, 40]] = [-1, T, -7]
        idx = torch.as_tensor(ids, device=dev)
        out = gather(table, idx, 2, 25)
        torch.cuda.synchronize()
        bad = torch.as_tensor((ids < 0) | (ids >= T), device=dev)
        assert not out[bad].any()
        assert torch.equal(out[~bad], table[idx[~bad].long(), 2:])


def test_full_gradient_step_matches_op_path(dev):
    tris = _moving_soup(dev)
    counts = {}
    grads = {}
    for shade in ("xla", "fused"):
        for kern in checks.KERNELS.values():
            kern.launches = 0
        grads[shade] = _grad_step(dev, tris, 2, 1 << 14, "reference",
                                  shade=shade)
        counts[shade] = {n: k.launches for n, k in checks.KERNELS.items()}
    none = {n: 0 for n in checks.KERNELS}
    assert counts["fused"] == {**none, "nearest_hit": 7, "bounce_pre": 3,
                               "bounce_post": 3, "bounce_pre_bwd": 3,
                               "bounce_post_bwd": 3, "scatter_add": 10,
                               "gather": 1}
    checks.leaves_close(grads["fused"], grads["xla"], checks.PATH_GRAD_RTOL,
                        checks.LEAF_ATOL, "fused vs op path")
    assert all(bool(torch.isfinite(g).all()) for g in grads["fused"].values())
    assert float(grads["fused"]["rx"].abs().max()) > 0


def test_stage_backward_kernels_reject_bad_operands(dev):
    spec = FusedSpec(nrx=1)
    R, T = 64, 128
    f = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                     device=dev)
    ok = dict(o=f(R, 3), d=f(R, 3), st=f(6, R),
              act=torch.ones(R, dtype=torch.bool, device=dev), idx=i32(R),
              table=f(T, 27), rx_pos=f(1, 3), sc=f(2), d_o2=f(R, 3),
              d_d2=f(R, 3), d_st2=f(6, R), d_ex=f(3, R), d_sh_d=f(1, R, 3),
              d_d2rx=f(1, R))
    fused_ops.bounce_pre_bwd(spec, *ok.values())
    torch.cuda.synchronize()
    for name, bad in (("idx", i32(R).long()), ("d_sh_d", f(2, R, 3)),
                      ("table", f(T, 26)), ("d_ex", f(3, R).cpu())):
        with pytest.raises(ValueError):
            fused_ops.bounce_pre_bwd(spec, *{**ok, name: bad}.values())
    with pytest.raises(ValueError):
        fused_ops.bounce_pre_bwd(FusedSpec(nrx=1, grad_positions=False,
                                           grad_geometry=False),
                                 *ok.values())
    with pytest.raises(ValueError, match="at most 340 RX"):
        fused_ops.bounce_pre_bwd(FusedSpec(nrx=341), *ok.values())
    with pytest.raises(ValueError):
        scatter_add(i32(R).long(), f(R, 3), T)
    with pytest.raises(ValueError):
        scatter_add(i32(R), f(R, 3), T, out=f(T, 27), col=25)


@pytest.mark.parametrize("T", [256, 131072])
def test_gather_kernel_equals_plain(dev, T):
    rng = np.random.default_rng(T)
    table = torch.as_tensor(rng.normal(size=(T, 27)).astype(np.float32),
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, T, (1 << 16) + 77).astype(
        np.int32), device=dev)
    before = gather.launches
    out = gather(table, idx)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    checks.hold_gather((table, idx), out, f"T={T}")
    assert torch.equal(gather(table, idx, 9, 3), table[idx.long(), 9:12])
    for bad in (dict(table=table.double()), dict(idx=idx.long()),
                dict(table=table.t().contiguous().t())):
        with pytest.raises(ValueError):
            gather(**{"table": table, "idx": idx, **bad})
    with pytest.raises(ValueError):
        gather(table, idx, 25, 3)


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_shade_kernel_equals_plain(dev, parity):
    tris = _moving_soup(dev)
    with checks.recording_fused() as calls:
        _grad_step(dev, tris, 2, 1 << 14, parity, shade="pallas")
    assert len(calls["shade_a"]) == 3
    for i, (args, out) in enumerate(calls["shade_a"]):
        checks.hold_shade(args, out, f"shade_a{i}")
        assert all(torch.equal(a, b) for a, b in zip(out, shade_a(*args)))
    with pytest.raises(ValueError):
        shade_a(*args[:4], args[4][:, :26].contiguous(), args[5])


@pytest.mark.parametrize("opt", ["plain", "t_max", "t_max_rays", "live",
                                 "all"])
@pytest.mark.parametrize("scene", ["soup", "box"])
def test_culled_kernel_equals_twin_and_plain(dev, scene, opt):
    rng = np.random.default_rng(6)
    host = (random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0)
            if scene == "soup" else box_scene())
    tris = flatten_scene(host, sort_triangles=True, device=dev)
    R = (1 << 16) + 77
    o, d, kw = _inputs(rng, opt, R, tris.pad_triangles, dev)
    skipped = torch.zeros(1, dtype=torch.int64, device=dev)
    before = nearest_hit_culled.launches
    t_k, i_k = nearest_hit_culled(o, d, tris, cull_boxes(tris),
                                  skipped=skipped, **kw)
    torch.cuda.synchronize()
    assert nearest_hit_culled.launches == before + 1
    t_t, i_t = intersect_torch(o, d, tris, chunk_size=8192, **kw)
    assert torch.equal(i_k, i_t) and torch.equal(t_k, t_t)
    reach = checks.hold_culled(o, d, tris, kw, t_k, i_k, int(skipped),
                               f"{scene}/{opt}")
    assert int(skipped) == int((~reach).sum())
    if scene == "box" and opt != "plain":     # rays of every block reach
        assert int(skipped) > 0               # every tile of the soup


def test_culled_kernel_rejects_bad_operands(dev):
    tris = flatten_scene(box_scene(), device=dev)
    o = torch.zeros((8, 3), device=dev)
    d = torch.ones((8, 3), device=dev)
    with pytest.raises(ValueError):
        nearest_hit_culled(o, d, tris, cull_boxes(tris)[:-1])
    with pytest.raises(ValueError):
        nearest_hit_culled(o, d, tris, cull_boxes(tris),
                           skipped=torch.zeros(1, device=dev))


def _scan_scene(dev, T, n=None, seed=7, copy=None):
    """A soup of ``n`` (default ``T - 9``) random triangles padded to
    exactly ``T``; with ``copy`` the soup's first ``copy`` triangles are
    followed by their exact copies (``copy`` rows later), so a hit on one
    ties with the other across tile edges of 64 and, for ``copy`` 200, of
    256."""
    m = random_soup_scene(n or max(T - 9, 1), seed=seed, extent=60.0,
                          tri_size=4.0).meshes[0]
    idx = m.indices.astype(np.int64)
    if copy is not None:
        idx = np.concatenate([idx[:copy], idx[:copy]])
    host = HostScene([HostMesh(m.vertices, idx,
                               material_index=m.material_index)])
    tris = flatten_scene(host, pad_to=T, device=dev)
    assert tris.pad_triangles == T
    return tris


def _scan_inputs(rng, tris, R, share, limit, dev):
    """A query of R rays, half of them (the first four always) aimed at a
    random triangle's centroid, with exclude (a random triangle, or for a
    quarter of the aimed rays their target), the given live share (a
    fraction scattered at random; "banded" fractions as runs of live rays
    in bands of 2048; "one_a_block": one live ray in every block of 256;
    "every_7th") and limit (None, "scalar" or "rays")."""
    T = tris.num_triangles
    cen = (tris.v0 + (tris.e1 + tris.e2) / 3.0)[:T].cpu().numpy()
    o = rng.uniform(-70, 70, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    aim = (rng.uniform(size=R) < 0.5) | (np.arange(R) < 4)
    target = rng.integers(0, T, int(aim.sum()))
    d[aim] = cen[target] - o[aim]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ex = rng.integers(-1, tris.pad_triangles, R).astype(np.int32)
    ex[np.flatnonzero(aim)[1::4]] = target[1::4]
    r = np.arange(R)
    if share == "one_a_block":
        live = r % 256 == 37 % min(R, 256)
    elif share == "every_7th":
        live = r % 7 == 0
    elif isinstance(share, str):                     # "0.17 banded"
        live = r % 2048 < float(share.split()[0]) * 2048
    else:
        live = rng.uniform(size=R) < share
    kw = dict(exclude=torch.as_tensor(ex, device=dev),
              live=torch.as_tensor(live, device=dev))
    if limit == "scalar":
        kw["t_max"] = 60.0
    elif limit == "rays":
        kw["t_max"] = torch.as_tensor(rng.uniform(0, 90, R).astype(
            np.float32), device=dev)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), kw


def _hold_scans(o, d, tris, kw, label):
    """The brute and the culled kernel, each twice, on the scene's records:
    the same bits in both runs, ``intersect_torch``'s bits, and the culled
    kernel's skip count ``culled_reach_plain``'s.  Returns ``(t, idx)``."""
    records = triangle_records(tris.v0, tris.e1, tris.e2)
    aabbs = cull_boxes(tris)
    t_p, i_p = intersect_torch(o, d, tris, chunk_size=4096, **kw)
    before = (nearest_hit.launches, nearest_hit_culled.launches)
    for _ in range(2):
        t_b, i_b = nearest_hit(o, d, tris, records=records, **kw)
        skipped = torch.zeros(1, dtype=torch.int64, device=o.device)
        t_c, i_c = nearest_hit_culled(o, d, tris, aabbs, skipped=skipped,
                                      records=records, **kw)
        torch.cuda.synchronize()
        for t, i in ((t_b, i_b), (t_c, i_c)):
            assert torch.equal(i, i_p), label
            assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
        checks.hold_culled(o, d, tris, kw, t_c, i_c, int(skipped), label)
    assert (nearest_hit.launches, nearest_hit_culled.launches) == (
        before[0] + 2, before[1] + 2)
    return t_p, i_p


@pytest.mark.parametrize("limit", [None, "scalar", "rays"])
@pytest.mark.parametrize("share", [0.0, "one_a_block", "every_7th", 0.17,
                                   "0.17 banded", 0.36, "0.36 banded", 1.0])
def test_scan_kernels_live_shares(dev, share, limit):
    rng = np.random.default_rng(31)
    tris = _scan_scene(dev, 2048)
    o, d, kw = _scan_inputs(rng, tris, (1 << 16) + 37, share, limit, dev)
    t, i = _hold_scans(o, d, tris, kw, f"{share}/{limit}")
    dead = ~kw["live"]
    assert bool((i[dead] == -1).all()) and bool(torch.isinf(t[dead]).all())
    assert (share == 0.0) == (not bool((i >= 0).any()))


@pytest.mark.parametrize("R", [1, 255, 257, (1 << 16) + 37, (1 << 18) + 37])
def test_scan_kernels_ray_counts(dev, R):
    # on an H100's 132 SMs the brute kernel's blocks take 32 rays up to
    # 2^16, 64 at 2^16 + 37 and 256 at 2^18 + 37 (brute_block_rays)
    rng = np.random.default_rng(32)
    tris = _scan_scene(dev, 2048)
    for share, limit in ((1.0, None), (0.36, "rays")):
        o, d, kw = _scan_inputs(rng, tris, R, share, limit, dev)
        _hold_scans(o, d, tris, kw, f"R={R}/{share}")


@pytest.mark.parametrize("T", [128, 256, 1000, 2048, 4095, 6000])
def test_scan_kernels_triangle_counts(dev, T):
    # 6000 triangles (288 KB of records) exceed the shared memory a block
    # could hold the whole scene in
    rng = np.random.default_rng(33)
    tris = _scan_scene(dev, T)
    for share, limit in ((1.0, "scalar"), ("one_a_block", None),
                         (0.17, "rays")):
        o, d, kw = _scan_inputs(rng, tris, 20000, share, limit, dev)
        _, i = _hold_scans(o, d, tris, kw, f"T={T}/{share}")
        assert bool((i >= 0).any())


@pytest.mark.parametrize("copy", [64, 200])
def test_scan_kernels_ties(dev, copy):
    rng = np.random.default_rng(34)
    tris = _scan_scene(dev, 512, n=copy, seed=9, copy=copy)
    o, d, kw = _scan_inputs(rng, tris, 30000, 0.52, "rays", dev)
    _, i = _hold_scans(o, d, tris, kw, f"ties/{copy}")
    # an original wins its tie unless it is the ray's excluded triangle
    h = i >= 0
    ex = kw["exclude"][h]
    assert bool(h.any()) and bool(((i[h] < copy) | (ex == i[h] - copy))
                                  .all())
    assert bool((i[h] >= copy).any())


def _edge_rays(rng, tris, R, dev):
    """R rays aimed at points a hair inside and outside random triangles'
    edges: barycentric u, v or 1 - u - v within 5e-7 of 0, where the exact
    tests on u and v decide and the division-free cut on u (mt.cuh) must
    keep every pair the exact test accepts."""
    T = tris.num_triangles
    v0, e1, e2 = (getattr(tris, f)[:T].cpu().numpy() for f in
                  ("v0", "e1", "e2"))
    k = rng.integers(0, T, R)
    off = rng.choice(np.float32([0, 1e-7, -1e-7, 2e-7, -2e-7, 5e-7, -5e-7]),
                     (R, 2))
    w = rng.uniform(0, 1, R).astype(np.float32)
    edge = rng.integers(0, 3, R)          # u = 0, v = 0 or u + v = 1
    a = np.where(edge == 0, off[:, 0], np.where(edge == 1, w, w + off[:, 0]))
    b = np.where(edge == 0, w, np.where(edge == 1, off[:, 1],
                                        1 - w + off[:, 1]))
    target = (v0[k] + a[:, None].astype(np.float32) * e1[k]
              + b[:, None].astype(np.float32) * e2[k])
    o = target + rng.normal(size=(R, 3)).astype(np.float32) * 30.0
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=dev),
            torch.as_tensor(d.astype(np.float32), device=dev))


def test_scan_kernels_edge_hits(dev):
    rng = np.random.default_rng(35)
    tris = _scan_scene(dev, 256)
    R = (1 << 16) + 37
    o, d = _edge_rays(rng, tris, R, dev)
    for kw in ({}, dict(live=torch.as_tensor(rng.uniform(size=R) < 0.36,
                                             device=dev))):
        _, i = _hold_scans(o, d, tris, kw, f"edges/{sorted(kw)}")
        assert bool((i >= 0).any())


def test_walk_kernel_edge_hits(dev):
    rng = np.random.default_rng(36)
    tris = _walk_scene(dev)
    scene = prepare_walk(tris)
    R = (1 << 16) + 37
    o, d = _edge_rays(rng, tris, R, dev)
    lim = query_limits(R, 256, device=dev)
    _, i = _hold_walk(scene, o, d, lim, None, False)
    assert bool((i >= 0).any())


def test_scan_kernels_reject_bad_records(dev):
    tris = _scan_scene(dev, 256)
    o = torch.zeros((8, 3), device=dev)
    d = torch.ones((8, 3), device=dev)
    records = triangle_records(tris.v0, tris.e1, tris.e2)
    with pytest.raises(ValueError):
        nearest_hit(o, d, tris, records=records[:-1])
    with pytest.raises(ValueError):
        nearest_hit_culled(o, d, tris, cull_boxes(tris),
                           records=records.double())
    misaligned = torch.empty(256 * 12 + 1, device=dev)[1:].view(256, 12)
    with pytest.raises(ValueError):
        nearest_hit(o, d, tris, records=misaligned)


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_pallas_op_path_matches_op_path(dev, parity):
    tris = _moving_soup(dev)
    grads, counts = {}, {}
    for kw in (dict(), dict(shade="pallas", cull=True)):
        for kern in checks.KERNELS.values():
            kern.launches = 0
        grads[bool(kw)] = _grad_step(dev, tris, 2, 1 << 14, parity, **kw)
        counts[bool(kw)] = {n: k.launches for n, k in checks.KERNELS.items()}
    none = {n: 0 for n in checks.KERNELS}
    n_fetch = 1 + 3 * (1 + (parity == "reference"))
    common = {"gather": n_fetch, "scatter_add": n_fetch}
    assert counts[False] == {**none, **common, "nearest_hit": 7}
    assert counts[True] == {**none, **common, "nearest_hit_culled": 7,
                            "shade_a": 3}
    checks.leaves_close(grads[True], grads[False], checks.PATH_GRAD_RTOL,
                        checks.LEAF_ATOL, "pallas vs xla op path")
    assert float(grads[True]["v0"].abs().max()) > 0


def _transmission_step(dev, tris, cfg, **kw):
    """One calibration step of ``cfg`` (``replace``d by ``kw``) on the card,
    its kernel calls recorded.  Returns the result, the material gradients,
    the calls and the launches."""
    mats = default_materials(dev)
    for kern in (*checks.KERNELS.values(), walk, walk_prepass):
        kern.launches = 0
    with checks.recording_fused() as calls:
        res, _ = checks.calibration_step(tris, RX[:2], TX, FREQ, mats,
                                         dataclasses.replace(cfg, **kw))
    launches = {n: k.launches for n, k in checks.KERNELS.items()}
    launches.update(walk=walk.launches, walk_prepass=walk_prepass.launches)
    return res, checks.grads_of(mats), calls, launches


@pytest.mark.parametrize("mode,shade,cull", [
    ("transmission", "xla", False), ("transmission", "pallas", False),
    ("transmission", "pallas", True), ("spawn_straight", "pallas", False),
    ("spawn_snell", "xla", False)])
def test_transmission_step_matches_torch_backend(dev, mode, shade, cull):
    """A calibration step under each transmission mode through the kernels:
    its launches; its written slots and material gradients against the same
    step through ``backend="torch"`` on the card (the op path's tier); every
    recorded gather, shading call, culled query and scatter-add against its
    plain version."""
    tris, _ = _soup(dev, 17)
    cfg = checks.transmission_config(1 << 14, 3, mode, shade=shade,
                                     cull=cull)
    res_k, g_k, calls, launches = _transmission_step(dev, tris, cfg)
    res_p, g_p, _, _ = _transmission_step(dev, tris, cfg, backend="torch")
    assert launches == checks.transmission_launches(cfg)
    for part in ("los", "scatter"):
        for f in checks.OUTPUT_FIELDS:
            checks.slots_agree(getattr(getattr(res_p, part), f),
                               getattr(getattr(res_k, part), f),
                               f"{part}.{f}")
    assert torch.equal(res_k.los_blocked, res_p.los_blocked)
    checks.leaves_close(g_k, g_p, checks.PATH_GRAD_RTOL, checks.LEAF_ATOL,
                        f"{mode} kernels vs torch backend")
    assert float(g_k["a"].abs().max()) > 0
    for i, (args, out) in enumerate(calls["gather"]):
        checks.hold_gather(args, out, f"gather{i}")
    for i, (args, out) in enumerate(calls["shade_a"]):
        checks.hold_shade(args, out, f"shade_a{i}")
    for i, (args, _) in enumerate(calls["scatter_add"]):
        checks.hold_scatter_add(*args, f"scatter_add{i}")
    for i, (args, (t, idx)) in enumerate(calls["nearest_hit_culled"]):
        o, d, q_tris, kw = args
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        t2, i2 = nearest_hit_culled(o, d, q_tris, skipped=skipped, **kw)
        assert torch.equal(t2, t) and torch.equal(i2, idx)
        checks.hold_culled(o, d, q_tris, kw, t, idx, int(skipped),
                           f"culled{i}")


@pytest.mark.parametrize("mode", sorted(checks.TRANSMISSION_MODES))
def test_transmission_fused_warns_and_equals_op_path(dev, mode):
    tris, _ = _soup(dev, 17)
    cfg = checks.transmission_config(1 << 14, 3, mode)
    res_x, g_x, _, n_x = _transmission_step(dev, tris, cfg)
    with pytest.warns(UserWarning, match="transmission modes"):
        res_f, g_f, _, n_f = _transmission_step(dev, tris, cfg,
                                                shade="fused")
    assert n_f == n_x == checks.transmission_launches(cfg)
    for part in ("los", "scatter"):
        for f in checks.OUTPUT_FIELDS:
            assert torch.equal(getattr(getattr(res_x, part), f),
                               getattr(getattr(res_f, part), f)), (part, f)
    assert all(torch.equal(g_x[f], g_f[f]) for f in g_x)


def test_transmission_walk_equals_brute(dev):
    """Under ``transmission`` the walk answers the shadow queries with the
    nearest blocker (any-hit off): the trace equals the brute scan's bit
    for bit."""
    tris = _walk_scene(dev)
    cfg = checks.transmission_config(1 << 14, 3, "transmission")
    out = {}
    for w in (False, True):
        res, grads, _, launches = _transmission_step(dev, tris, cfg, walk=w)
        assert launches == checks.transmission_launches(
            dataclasses.replace(cfg, walk=w), walk=w)
        out[w] = (res, grads)
    for part in ("los", "scatter"):
        for f in checks.OUTPUT_FIELDS:
            assert torch.equal(getattr(getattr(out[False][0], part), f),
                               getattr(getattr(out[True][0], part), f)), f
    assert all(torch.equal(out[False][1][f], out[True][1][f])
               for f in out[False][1])


def test_two_rank_ray_sharded_step_equals_single_process(dev, tmp_path):
    """``bench.py``'s step at 2^16 paths over two gloo ranks sharing the
    card (``parallel.trace_paths_sharded``, rays 2 x tris 1): the gathered
    outputs the single-process step's bits, the material gradients within
    rtol 1e-5 and 1e-12 (``tests/test_sharding.py:67-70``), on each rank."""
    import os
    import socket
    import subprocess
    import sys

    import _torch_sharding_worker as worker
    from hermespy_rt_tpu_torch.ops._cuda_build import LIBRARY

    LIBRARY.build()          # once, before the ranks load it
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests",
                                      "_torch_sharding_worker.py"),
         str(r), "2", str(port), "2", "1", str(tmp_path), "cuda",
         "card_step"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=repo), cwd=repo)
        for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ref = worker.case_card_step(worker.single, dev)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k, v in ref.items():
            if k.startswith("d_"):
                np.testing.assert_allclose(got[f"card_step/{k}"], v,
                                           rtol=1e-5, atol=1e-12, err_msg=k)
            else:
                np.testing.assert_array_equal(got[f"card_step/{k}"], v,
                                              err_msg=k)
