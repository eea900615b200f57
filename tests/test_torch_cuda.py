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
The row gather must equal ``table[idx]`` bit for bit; the shading kernel
its plain version on a trace's recorded calls (a dead ray's state bit for
bit, the rest within its tier); the culled query the brute twin's decisions
and its skip count the plain version's; the op path with every kernel
(``shade="pallas", cull=True``) the op path's gradients.
The walk's prepass kernel must give the reach and key of its plain version
bit for bit, and the walk kernel the (t, idx) of its plain version and of
the brute kernel (in any-hit mode the same `blocked`, each reported hit a
valid one); traces through the walk equal traces through the brute kernel
bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from hermespy_rt_tpu_torch import compute_paths, default_materials
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.ops.bounce_fused import FusedSpec
from hermespy_rt_tpu_torch.ops.fetch_cuda import gather, scatter_add
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch, mt_hit
from hermespy_rt_tpu_torch.ops.intersect_cuda import (nearest_hit,
                                                      nearest_hit_culled)
from hermespy_rt_tpu_torch.ops.shade_cuda import shade_a
from hermespy_rt_tpu_torch.ops.walk import (cull_boxes, prepare_walk,
                                            prepass_plain, query_limits,
                                            visit_rows, walk_plain)
from hermespy_rt_tpu_torch.ops.walk_cuda import walk, walk_prepass, walk_query
from hermespy_rt_tpu_torch.scene import (HostMesh, HostScene, box_scene,
                                         flatten_scene, random_soup_scene)

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
    reach, key = walk_prepass(o, d, lim, scene.boxes)
    torch.cuda.synchronize()
    assert walk_prepass.launches == before + 1
    r_p, k_p = prepass_plain(o, d, lim, scene.boxes, scene.block_rays)
    assert torch.equal(reach, r_p) and torch.equal(key, k_p)
    assert torch.equal(visit_rows(reach, key), visit_rows(r_p, k_p))


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
    visits = visit_rows(*walk_prepass(o, d, lim, scene.boxes))
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


def test_walk_rejects_bad_operands(dev):
    tris = _walk_scene(dev)
    scene = prepare_walk(tris)
    o = torch.zeros((8, 3), device=dev)
    d = torch.ones((8, 3), device=dev)
    lim = query_limits(8, scene.block_rays, device=dev)
    visits = visit_rows(*walk_prepass(o, d, lim, scene.boxes))
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
