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
in two runs), and one fused forward+backward step against the op path."""
import dataclasses

import numpy as np
import pytest
import torch

from hermespy_rt_tpu_torch import compute_paths, default_materials
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.ops.bounce_fused import FusedSpec
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch
from hermespy_rt_tpu_torch.ops.intersect_cuda import nearest_hit
from hermespy_rt_tpu_torch.scene import (box_scene, flatten_scene,
                                         random_soup_scene)

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
    assert launches["fused"] == {"nearest_hit": 7, "bounce_pre": 3,
                                 "bounce_post": 3, "loop_bwd_slim": 1}
    assert launches["xla"] == {"nearest_hit": 7, "bounce_pre": 0,
                               "bounce_post": 0, "loop_bwd_slim": 0}
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
