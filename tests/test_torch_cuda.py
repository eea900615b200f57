"""Tests of the CUDA nearest-hit kernel on the card.

They need an NVIDIA GPU with nvcc and skip elsewhere.  The file imports no
JAX, so it runs where JAX is absent; run it without the repo's conftest
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel must make exactly the decisions of its plain torch twin on the
same card (both round every product and sum on its own, in the same order),
and the trace through it must agree with the trace through the twin to the
tier of ``tests/test_pallas.py``."""
import numpy as np
import pytest
import torch

from hermespy_rt_tpu_torch import compute_paths
from hermespy_rt_tpu_torch.ops.intersect import intersect_torch
from hermespy_rt_tpu_torch.ops.intersect_cuda import nearest_hit
from hermespy_rt_tpu_torch.scene import (box_scene, flatten_scene,
                                         random_soup_scene)

pytestmark = pytest.mark.cuda


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
