"""Public API of the PyTorch port: the shape and dtype contract of
``tests/test_api.py``, argument validation, ``.hrt`` input, agreement of
``compute_paths`` with the JAX package's, and that importing the port
leaves JAX out."""
import _torch_threads  # noqa: F401  (first: the thread share)

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu as J
import hermespy_rt_tpu_torch as hrt
from hermespy_rt_tpu_torch import testing as checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reference_shape_contract():
    num_rx, num_tx, num_paths, num_bounces = 2, 3, 100, 3
    rng = np.random.default_rng(0)
    rx = rng.uniform(-1, 1, (num_rx, 3))
    tx = rng.uniform(-1, 1, (num_tx, 3)) + np.array([0, 0, 2.0])
    z_rx, z_tx = np.zeros((num_rx, 3)), np.zeros((num_tx, 3))
    los, scatter = hrt.compute_paths(
        hrt.box_scene(), rx, tx, z_rx, z_tx, 3.0,
        num_rx, num_tx, num_paths, num_bounces, device="cpu")

    assert los.num_rays == 1
    assert ((num_rx, num_tx, 1, 3) == los.directions_rx.shape
            == los.directions_tx.shape)
    assert ((num_rx, num_tx, 1) == los.a_te.shape == los.a_tm.shape
            == los.tau.shape == los.freq_shift.shape)
    assert scatter.num_rays == num_bounces * num_paths
    assert ((num_rx, num_tx, scatter.num_rays, 3)
            == scatter.directions_rx.shape == scatter.directions_tx.shape)
    assert ((num_rx, num_tx, scatter.num_rays) == scatter.a_te.shape
            == scatter.a_tm.shape == scatter.tau.shape
            == scatter.freq_shift.shape)
    for info in (los, scatter):
        assert info.a_te.dtype == info.a_tm.dtype == torch.complex64
        assert info.tau.dtype == info.freq_shift.dtype == torch.float32
        assert info.directions_rx.dtype == torch.float32
        assert info.tau.device.type == "cpu"


def test_compute_paths_matches_jax_on_hrt_file(tmp_path):
    path = str(tmp_path / "reflector.hrt")
    J.save_hrt(J.simple_reflector_scene(), path)
    rx, tx = np.array([[0., 0., .15]]), np.array([[0., 0., .151]])
    z = np.zeros((1, 3))
    los_j, sc_j = J.compute_paths(path, rx, tx, z, z, 3.0, 1, 1, 500, 2,
                                  backend="jnp")
    los_t, sc_t = hrt.compute_paths(path, rx, tx, z, z, 3.0, 1, 1, 500, 2,
                                    backend="torch", device="cpu")
    assert float(los_t.a_te.abs()[0, 0, 0]) == 1.0
    np.testing.assert_allclose(los_t.a_te.numpy(), np.asarray(los_j.a_te),
                               rtol=1e-6)
    a_j, a_t = np.asarray(sc_j.a_te), sc_t.a_te.numpy()
    assert ((np.abs(a_j) > 0) == (np.abs(a_t) > 0)).mean() > 0.995
    m = (np.abs(a_j) > 0) & (np.abs(a_t) > 0)
    np.testing.assert_allclose(a_t[m], a_j[m], rtol=1e-4,
                               atol=np.abs(a_j[m]).max() * 1e-5)


def test_row_count_validation():
    with pytest.raises(ValueError):
        hrt.compute_paths(hrt.box_scene(), np.zeros((2, 3)), np.zeros((1, 3)),
                          np.zeros((2, 3)), np.zeros((1, 3)), 3.0,
                          1, 1, 10, 1, device="cpu")
    with pytest.raises(ValueError):
        hrt.compute_paths(hrt.box_scene(), np.zeros((1, 3)), np.zeros((1, 3)),
                          np.zeros((1, 3)), np.zeros((1, 3)), 3.0,
                          1, 1, 10, 1, backend="pallas", device="cpu")


def test_unsupported_scene_format():
    with pytest.raises(ValueError):
        hrt.load_scene("scene.obj")


def test_trace_returns_rays_info():
    res = hrt.trace(hrt.box_scene(), [[1., 1., 1.]], [[-1., -1., 2.]],
                    config=hrt.TracerConfig(num_paths=64, num_bounces=2),
                    device="cpu")
    ri = res.rays_scatter
    assert ri.origins.shape == (1, 3, 64, 3)
    assert ri.active.shape == (1, 3, 64)
    assert bool(ri.active[0, 0].all())
    assert res.rays_los.origins.shape == (1, 1, 1, 3)
    assert res.los_blocked.shape == (1, 1)


def test_prepare_scene_passes_soa_through():
    soa = hrt.prepare_scene(hrt.box_scene(), pad_to=64, device="cpu")
    assert soa.pad_triangles == 64 and soa.num_triangles == 12
    assert hrt.prepare_scene(soa) is soa


def test_trace_carries_position_and_frequency_gradients():
    """Positions and the carrier frequency given as tensors keep their
    gradients through ``trace`` (the op path here), as JAX's ``api.trace``
    does: ``torch.autograd.grad`` against ``jax.grad``, each leaf within
    3e-5 of its largest magnitude plus 1e-16."""
    rx = np.array([[0.5, 0.2, 1.0], [-1.0, 2.0, 0.5]], np.float32)
    tx = np.array([[0.0, 0.0, 1.5]], np.float32)
    kw = dict(num_paths=256, num_bounces=2, keep_rays=False)

    def jax_loss(rx_, tx_, f):
        res = J.trace(J.box_scene(), rx_, tx_, carrier_frequency=f,
                      config=J.TracerConfig(backend="jnp", **kw))
        return ((jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
                 + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)) * 1e9
                + jnp.sum(res.scatter.tau) * 1e3)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(rx), jnp.asarray(tx), jnp.float32(3.0))
    leaves = (torch.tensor(rx, requires_grad=True),
              torch.tensor(tx, requires_grad=True),
              torch.tensor(3.0, requires_grad=True))
    res = hrt.trace(hrt.box_scene(), leaves[0], leaves[1],
                    carrier_frequency=leaves[2],
                    config=hrt.TracerConfig(**kw), device="cpu")
    loss = ((res.scatter.a_te.abs().square().sum()
             + res.scatter.a_tm.abs().square().sum()) * 1e9
            + res.scatter.tau.sum() * 1e3)
    ours = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(("rx", "tx", "frequency"), ours, ref):
        checks.leaves_close({name: a}, {name: torch.tensor(np.asarray(b))},
                            checks.LEAF_RTOL, checks.LEAF_ATOL, "trace")
        assert float(a.abs().max()) > 0, name


def test_import_leaves_jax_out():
    code = ("import sys, hermespy_rt_tpu_torch, hermespy_rt_tpu_torch.convert,"
            " hermespy_rt_tpu_torch.ops.intersect_cuda,"
            " hermespy_rt_tpu_torch.ops.bounce_fused_cuda,"
            " hermespy_rt_tpu_torch.ops.fetch,"
            " hermespy_rt_tpu_torch.ops.fetch_cuda,"
            " hermespy_rt_tpu_torch.ops.walk,"
            " hermespy_rt_tpu_torch.ops.walk_cuda,"
            " hermespy_rt_tpu_torch.scene.sionna,"
            " hermespy_rt_tpu_torch.models,"
            " hermespy_rt_tpu_torch.models.channel,"
            " hermespy_rt_tpu_torch.models.coverage,"
            " hermespy_rt_tpu_torch.models.sweep,"
            " hermespy_rt_tpu_torch.utils,"
            " hermespy_rt_tpu_torch.utils.validation,"
            " hermespy_rt_tpu_torch.utils.profiling,"
            " hermespy_rt_tpu_torch.parallel,"
            " hermespy_rt_tpu_torch.parallel.sharding,"
            " hermespy_rt_tpu_torch.cli, hermespy_rt_tpu_torch.bench,"
            " hermespy_rt_tpu_torch.viz,"
            " hermespy_rt_tpu_torch.scene.native,"
            " hermespy_rt_tpu_torch.testing, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hermespy_rt_tpu.', "
            "'config5_scene', 'config5_e2e', 'benchmarks')) "
            "or m == 'hermespy_rt_tpu'); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # nor does any source of the port, nor chip_smoke.py, import them where
    # the import above does not reach (inside a function)
    srcs = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(dirpath, f)
        for dirpath, _, names in os.walk(os.path.join(REPO,
                                                      "hermespy_rt_tpu_torch"))
        for f in sorted(names) if f.endswith(".py")]
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|benchmarks|"
                        r"config5_\w+|hermespy_rt_tpu(?!_torch))\b", re.M)
    for src in srcs:
        with open(src) as f:
            assert not banned.search(f.read()), src


def test_entry_points_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU; on a
    machine without one, the default raises as torch does (no fallback)."""
    for fn in (hrt.compute_paths, hrt.trace, hrt.prepare_scene,
               hrt.default_materials, hrt.flatten_scene, hrt.MaterialTable):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            hrt.default_materials()
