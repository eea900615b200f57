"""PyTorch port vs JAX package: the channel models, coverage maps, the
resumable sweeps and the validation utilities.

``tests/test_models.py``'s seven cases and ``tests/test_sweep_validation.py``'s
four run on the port (CPU, the plain nearest hit), each held against the
JAX function on the same inputs: the channel functions' values and their
material gradients (rtol 1e-4 with a floor of 1e-5 of the largest
magnitude, as ``tests/test_torch_tracer.py``), coverage maps with and
without ``transmission`` (the same blockage, gains within that tier), the
sweep's chunks read by both packages' ``load_sweep_results`` and resumed by
either, and the validators' verdicts."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu as J
from hermespy_rt_tpu.models import channel as jch
from hermespy_rt_tpu.models import coverage as jcov
from hermespy_rt_tpu.models import sweep as jsw
from hermespy_rt_tpu.utils import validation as jval
import hermespy_rt_tpu_torch as hrt
from hermespy_rt_tpu_torch.convert import materials_from_jax, soa_from_jax
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.models import channel as tch
from hermespy_rt_tpu_torch.models import (CoverageGrid, SweepConfig,
                                          coverage_map, load_sweep_results,
                                          run_sweep)
from hermespy_rt_tpu_torch.utils import (SceneValidationError, check_finite,
                                         validate_inputs, validate_scene)

RX = [[0.0, 0.0, 0.15]]
TX = [[0.0, 0.0, 0.151]]
CFG = dict(num_paths=512, num_bounces=2, keep_rays=False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(ref, ours, label):
    ref, ours = np.asarray(ref), _np(ours)
    assert ref.shape == ours.shape, f"{label}: {ref.shape} vs {ours.shape}"
    np.testing.assert_array_equal(np.abs(ours) > 0, np.abs(ref) > 0,
                                  err_msg=f"{label}: masks")
    np.testing.assert_allclose(ours, ref, rtol=1e-4,
                               atol=np.abs(ref).max() * 1e-5 + 1e-30,
                               err_msg=label)


def _traces(scene_fn, rx, tx, rxv=None, **kw):
    """The same trace on both packages (JAX ``backend="jnp"``, the port
    ``backend="torch"`` on the CPU)."""
    ref = J.trace(getattr(J, scene_fn)(), rx, tx, rxv, None, 3.0,
                  config=J.TracerConfig(backend="jnp", **kw))
    ours = hrt.trace(getattr(hrt, scene_fn)(), rx, tx, rxv, None, 3.0,
                     config=hrt.TracerConfig(backend="torch", **kw),
                     device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def reflector():
    return _traces("simple_reflector_scene", RX, TX, **CFG)


def test_combine_shapes(reflector):
    ref, ours = reflector
    a, tau, nu = tch.combine_paths(ours)
    assert a.shape == (1, 1, 1 + 2 * 512)
    assert tau.shape == a.shape == nu.shape
    for pol in ("te", "tm"):
        for x, y, name in zip(jch.combine_paths(ref, pol),
                              tch.combine_paths(ours, pol),
                              ("a", "tau", "nu")):
            _close(x, y, f"{pol} {name}")


def test_cir_energy_and_peak(reflector):
    ref, ours = reflector
    h = tch.cir(ours, sampling_rate=1e9, num_taps=32)
    assert h.shape == (1, 1, 32) and h.dtype == torch.complex64
    h0 = _np(h)[0, 0]
    assert np.argmax(np.abs(h0)) == 0
    assert abs(abs(h0[0]) - 1.0) < 0.1
    _close(jch.cir(ref, 1e9, 32), h, "cir")
    _close(jch.cir(ref, 2e9, 16, time=1e-4, polarization="tm"),
           tch.cir(ours, 2e9, 16, time=1e-4, polarization="tm"), "cir tm")


def test_narrowband_doppler_rotation():
    ref, ours = _traces("simple_reflector_scene", RX, TX,
                        rxv=[[0.0, 0.0, -10.0]], num_paths=128,
                        num_bounces=1, keep_rays=False)
    t = np.linspace(0, 1e-3, 8)
    h = tch.narrowband_coefficients(ours, 3.0, t)
    assert h.shape == (1, 1, 8)
    ph = np.angle(_np(h)[0, 0])
    assert np.abs(np.diff(ph)).max() > 1e-4
    _close(jch.narrowband_coefficients(ref, 3.0, t), h, "narrowband")


def test_path_gain_and_delay_spread_finite_and_differentiable(reflector):
    ref, ours = reflector
    g = float(tch.path_gain_db(ours)[0, 0].detach())
    ds = float(tch.rms_delay_spread(ours)[0, 0].detach())
    assert np.isfinite(g) and g <= 1.0
    assert 0.0 <= ds < 1e-6
    np.testing.assert_allclose(g, float(jch.path_gain_db(ref)[0, 0]),
                               rtol=1e-5)
    np.testing.assert_allclose(ds, float(jch.rms_delay_spread(ref)[0, 0]),
                               rtol=1e-4)

    j_tris = J.flatten_scene(J.simple_reflector_scene())
    rx, tx = np.asarray(RX, np.float32), np.asarray(TX, np.float32)
    z = np.zeros((1, 3), np.float32)
    jcfg = J.TracerConfig(backend="jnp", **CFG)

    def jax_loss(m):
        res = J.trace_paths(j_tris, m, rx, tx, z, z, 3.0, jcfg)
        return (jnp.sum(jnp.abs(jch.cir(res, 1e9, 16)) ** 2)
                + jnp.sum(jch.rms_delay_spread(res)) * 1e8)

    g_ref = jax.jit(jax.grad(jax_loss))(J.default_materials())
    mats = materials_from_jax(vars(J.default_materials()))
    res = hrt.trace_paths(soa_from_jax(vars(j_tris)), mats, rx, tx, z, z,
                          3.0, hrt.TracerConfig(backend="torch", **CFG))
    loss = (tch.cir(res, 1e9, 16).abs().square().sum()
            + tch.rms_delay_spread(res).sum() * 1e8)
    loss.backward()
    assert torch.isfinite(mats.s.grad).all()
    assert np.abs(np.asarray(g_ref.s)).max() > 0
    for f in MATERIAL_FIELDS:
        p = getattr(mats, f)
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        want = np.asarray(getattr(g_ref, f))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=np.abs(want).max() * 1e-5 + 1e-30,
                                   err_msg=f)


def _coverage_both(tx, x_range, y_range, height, cfg_kw, batch_size):
    kw = dict(x_range=x_range, y_range=y_range, resolution=2.0,
              height=height, batch_size=batch_size)
    ref = jcov.coverage_map(J.box_scene(), tx,
                            config=J.TracerConfig(backend="jnp", **cfg_kw),
                            **kw)
    ours = coverage_map(hrt.box_scene(), tx,
                        config=hrt.TracerConfig(backend="torch", **cfg_kw),
                        device="cpu", **kw)
    assert isinstance(ours, CoverageGrid)
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.y, ref.y)
    assert ours.height == ref.height
    for f in ("gain_db", "rms_delay"):
        x = getattr(ours, f)
        assert isinstance(x, np.ndarray) and x.dtype == np.float32
        np.testing.assert_allclose(x, getattr(ref, f), rtol=1e-4,
                                   atol=np.abs(getattr(ref, f)).max() * 1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(ours.los_blocked, ref.los_blocked)
    return ours


def test_coverage_map():
    # 25 probes in batches of 16: the last batch is zero-padded
    grid = _coverage_both([[0.0, 0.0, 4.0]], (-4, 4), (-4, 4), 1.0,
                          dict(num_paths=64, num_bounces=2, keep_rays=False),
                          16)
    assert grid.gain_db.shape == (5, 5)
    assert np.isfinite(grid.gain_db).all()
    assert not grid.los_blocked.any()
    assert grid.gain_db[2, 2] >= grid.gain_db[0, 0]


def test_los_blocked_under_transmission():
    """A blocked LoS under transmission keeps a nonzero penetration-loss
    gain; los_blocked carries the decision either way."""
    kw = dict(num_paths=64, num_bounces=1, keep_rays=False,
              parity="physical")
    for transmission in (True, False):
        ref, ours = _traces("box_scene", [[0.0, 0.0, 1.0]],
                            [[0.0, 0.0, 40.0]], transmission=transmission,
                            **kw)
        blocked = _np(ours.los_blocked)
        assert blocked.shape == (1, 1) and blocked[0, 0]
        np.testing.assert_array_equal(blocked, np.asarray(ref.los_blocked))
        a = np.abs(_np(ours.los.a_te))[0, 0, 0]
        assert (a > 0.0) if transmission else (a == 0.0)
        _close(ref.los.a_te, ours.los.a_te, f"los a_te {transmission}")


def test_coverage_map_transmission():
    grid = _coverage_both([[0.0, 0.0, 40.0]], (-2, 2), (-2, 2), 1.0,
                          dict(num_paths=64, num_bounces=1, keep_rays=False,
                               parity="physical", transmission=True), 9)
    assert grid.los_blocked.all()
    assert np.isfinite(grid.gain_db).all()


def test_sweep_runs_and_resumes(tmp_path):
    tracer = dict(num_paths=64, num_bounces=2, keep_rays=False)
    cfg = SweepConfig(output_dir=str(tmp_path / "port"), chunk_size=4,
                      tracer=hrt.TracerConfig(backend="torch", **tracer))
    jcfg = jsw.SweepConfig(output_dir=str(tmp_path / "jax"), chunk_size=4,
                           tracer=J.TracerConfig(backend="jnp", **tracer))
    rng = np.random.default_rng(0)
    rx = rng.uniform(-2, 2, (10, 3)).astype(np.float32) + [0, 0, 1.0]
    tx = np.array([[0.0, 0.0, 2.0]], np.float32)

    def port(out_dir=cfg.output_dir):
        return run_sweep(hrt.box_scene(), tx, rx,
                         dataclasses.replace(cfg, output_dir=out_dir),
                         device="cpu")

    def jax_(out_dir=jcfg.output_dir):
        return jsw.run_sweep(J.box_scene(), tx, rx,
                             dataclasses.replace(jcfg, output_dir=out_dir))

    assert port() == 3
    assert port() == 0
    os.remove(os.path.join(cfg.output_dir, "chunk_00001.npz"))
    assert port() == 1
    assert jax_() == 3
    # either package resumes the other's sweep: nothing left to compute
    assert jax_(cfg.output_dir) == 0 and port(jcfg.output_dir) == 0
    for name in ("manifest.json",):
        with open(os.path.join(cfg.output_dir, name)) as f:
            m_port = json.load(f)
        with open(os.path.join(jcfg.output_dir, name)) as f:
            assert json.load(f) == m_port
    ours = list(load_sweep_results(cfg.output_dir))
    by_jax = list(jsw.load_sweep_results(cfg.output_dir))
    ref = list(load_sweep_results(jcfg.output_dir))
    assert len(ours) == len(by_jax) == len(ref) == 3
    assert sum(c["a_te"].shape[0] for c in ours) == 10
    assert ours[0]["a_te"].shape[1:] == (1, 128)
    for c_ours, c_jax, c_ref in zip(ours, by_jax, ref):
        assert sorted(c_ours) == sorted(c_ref) == sorted(c_jax)
        for k in c_ref:
            assert c_ours[k].dtype == c_ref[k].dtype, k
            np.testing.assert_array_equal(c_jax[k], c_ours[k])
            _close(c_ref[k], c_ours[k], k)


def _scene_cases(lib):
    H, M = lib.HostScene, lib.HostMesh
    return {
        "good": lib.box_scene(),
        "bad_index": H([M(np.zeros((3, 3), np.float32),
                          np.array([[0, 1, 5]], np.uint32))]),
        "nan_vertex": H([M(np.array([[0, 0, np.nan], [1, 0, 0], [0, 1, 0]],
                                    np.float32),
                           np.array([[0, 1, 2]], np.uint32))]),
        "empty": H([]),
        "degenerate": H([M(np.zeros((3, 3), np.float32),
                           np.array([[0, 1, 2]], np.uint32))]),
        "unknown_material": H([M(np.eye(3, dtype=np.float32),
                                 np.array([[0, 1, 2]], np.uint32),
                                 material_index=40, name="odd")]),
    }


def _verdict(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:   # the class and message are the verdict
        return (type(e).__name__, str(e))


def test_validate_scene_catches_errors():
    jax_cases, ours = _scene_cases(J.scene), _scene_cases(hrt.scene)
    assert validate_scene(ours["good"]) == []
    for name in ("bad_index", "nan_vertex", "empty"):
        with pytest.raises(SceneValidationError):
            validate_scene(ours[name])
    assert any("degenerate" in w for w in validate_scene(ours["degenerate"]))
    for name in jax_cases:
        for strict in (False, True):
            assert (_verdict(validate_scene, ours[name],
                             strict_materials=strict)
                    == _verdict(jval.validate_scene, jax_cases[name],
                                strict_materials=strict)), (name, strict)


def test_validate_inputs():
    z = np.zeros((1, 3))
    cases = [(z, z, z, z, 3.0), (np.zeros((1, 2)), z, z, z, 3.0),
             (z, z, z, z, 0.0), (z * np.nan, z, z, z, 3.0),
             (z, z, np.zeros((2, 3)), z, 3.0),
             (z, np.zeros((2, 3)), z, z, 3.0)]
    assert validate_inputs(*cases[0]) is None
    for args in cases[1:]:
        with pytest.raises(ValueError):
            validate_inputs(*args)
    for args in cases:
        assert _verdict(validate_inputs, *args) == _verdict(
            jval.validate_inputs, *args)
    # tensors are taken as they are, on their device
    validate_inputs(*(torch.zeros(1, 3) for _ in range(4)), 3.0)


def test_check_finite_passes_on_real_trace():
    kw = dict(num_paths=64, num_bounces=2)
    ref, ours = _traces("box_scene", [[1.0, 1.0, 1.0]], [[-1.0, -1.0, 2.0]],
                        **kw)
    assert check_finite(ours) == [] == jval.check_finite(ref)
    bad_tau = ours.scatter.tau.clone()
    bad_tau[0, 0, :3] = float("nan")
    bad = dataclasses.replace(ours, scatter=dataclasses.replace(
        ours.scatter, tau=bad_tau))
    bad_ref = dataclasses.replace(ref, scatter=dataclasses.replace(
        ref.scatter, tau=jnp.asarray(_np(bad_tau))))
    assert check_finite(bad, raise_on_fail=False) == jval.check_finite(
        bad_ref, raise_on_fail=False) == ["scatter.tau: 3 non-finite values"]
    with pytest.raises(FloatingPointError):
        check_finite(bad)


def test_model_entry_points_default_to_the_card(tmp_path):
    """coverage_map and run_sweep run on the card unless the caller asks for
    the CPU; without one the default raises, as torch does."""
    for fn in (coverage_map, run_sweep):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        cfg = hrt.TracerConfig(num_paths=16, num_bounces=1, keep_rays=False)
        with pytest.raises((RuntimeError, AssertionError)):
            coverage_map(hrt.box_scene(), [[0.0, 0.0, 4.0]], (-1, 1), (-1, 1),
                         resolution=2.0, config=cfg)
        with pytest.raises((RuntimeError, AssertionError)):
            run_sweep(hrt.box_scene(), [[0.0, 0.0, 4.0]], [[1.0, 1.0, 1.0]],
                      SweepConfig(str(tmp_path), tracer=cfg))
