"""PyTorch port vs JAX package: launch directions, vector helpers and the
elementwise physics (fast_acos, eta precompute, Fresnel, scattering).

Inputs are made with numpy from a seed and fed to both packages.  Tolerance
rtol 1e-6 / atol 1e-7 throughout: the two sides run the same f32 operations
in the same order, and the remaining differences are the last-ulp results of
the libraries' own pow/exp/sin/sqrt."""
import _torch_threads  # noqa: F401  (first: the thread share)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hermespy_rt_tpu import materials as jmat
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.ops import fresnel as jfres
from hermespy_rt_tpu.ops import geometry as jgeo
from hermespy_rt_tpu.ops.scattering import scat_coefs as jax_scat
from hermespy_rt_tpu_torch import TracerConfig
from hermespy_rt_tpu_torch import materials as tmat
from hermespy_rt_tpu_torch.materials import (MATERIAL_FIELDS, NUM_MATERIALS,
                                             default_materials,
                                             get_material_index)
from hermespy_rt_tpu_torch.ops import fresnel as tfres
from hermespy_rt_tpu_torch.ops import geometry as tgeo
from hermespy_rt_tpu_torch.ops.scattering import scat_coefs

RTOL, ATOL = 1e-6, 1e-7


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 7, 1000, 65537])
def test_fibonacci_sphere_bit_equal(n):
    np.testing.assert_array_equal(tgeo.fibonacci_sphere(n),
                                  jgeo.fibonacci_sphere(n))


def test_vector_helpers_match(rng):
    a = rng.normal(size=(512, 3)).astype(np.float32)
    b = rng.normal(size=(512, 3)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    _close(tgeo.dot3(ta, tb), jgeo.dot3(jnp.asarray(a), jnp.asarray(b)))
    _close(tgeo.cross3(ta, tb), jgeo.cross3(jnp.asarray(a), jnp.asarray(b)))
    _close(tgeo.reflect3(ta, tb), jgeo.reflect3(jnp.asarray(a),
                                                jnp.asarray(b)))
    _close(tgeo.normalize3(ta), jgeo.normalize3(jnp.asarray(a)))


def test_fast_acos_matches(rng):
    x = np.concatenate([rng.uniform(-1, 1, 4096),
                        [-1.0, -0.5, 0.0, 0.5, 1.0]]).astype(np.float32)
    _close(tgeo.fast_acos(torch.as_tensor(x)), jgeo.fast_acos(jnp.asarray(x)))


def test_material_table():
    t = default_materials(device="cpu")
    j = jax_materials()
    assert t.num_materials == NUM_MATERIALS == 17
    for f in MATERIAL_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).detach().numpy(),
                                      np.asarray(getattr(j, f)))
        assert getattr(t, f).requires_grad
    assert get_material_index("metal") == 13
    assert get_material_index("no_such_material") == 0


MATERIAL_IDS = ["AIR", "CONCRETE", "BRICK", "PLASTERBOARD", "WOOD", "GLASS1",
                "GLASS2", "CEILING_BOARD1", "CEILING_BOARD2", "CHIPBOARD",
                "PLYWOOD", "MARBLE", "FLOORBOARD", "METAL", "VERY_DRY_GROUND",
                "MEDIUM_DRY_GROUND", "WET_GROUND"]


@pytest.mark.parametrize("name", MATERIAL_IDS)
def test_material_id_constants_match(name):
    """Each ``MATERIAL_<NAME>`` id equals the JAX package's and names the
    same row of ``MATERIAL_NAMES`` and ``MATERIAL_KEYS``."""
    ours = getattr(tmat, f"MATERIAL_{name}")
    assert ours == getattr(jmat, f"MATERIAL_{name}")
    assert tmat.MATERIAL_NAMES[ours] == jmat.MATERIAL_NAMES[ours]
    assert tmat.MATERIAL_KEYS[name.lower()] == ours


@pytest.mark.parametrize("f_ghz", [0.5, 3.0, 28.0, 70.0])
def test_precompute_eta_matches(f_ghz):
    ours = tfres.precompute_eta(default_materials(device="cpu"), f_ghz)
    ref = jfres.precompute_eta(jax_materials(), f_ghz)
    for f in tfres.ETA_FIELDS:
        _close(getattr(ours, f), getattr(ref, f))


def _eta_rows(rng, n, f_ghz=3.0):
    mat = rng.integers(0, NUM_MATERIALS, n)
    ref = jfres.precompute_eta(jax_materials(), f_ghz)
    # gather the SAME per-material values on both sides
    rows = {f: np.asarray(getattr(ref, f))[mat] for f in tfres.ETA_FIELDS}
    t_rows = tfres.EtaPrecomputed(**{f: torch.as_tensor(v)
                                     for f, v in rows.items()})
    j_rows = jfres.EtaPrecomputed(**{f: jnp.asarray(v)
                                     for f, v in rows.items()})
    return t_rows, j_rows


def test_refl_coefs_match(rng):
    n = 4096
    t_rows, j_rows = _eta_rows(rng, n)
    cos_t1 = rng.uniform(0, 1, n).astype(np.float32)
    sin_t1 = np.sqrt(1 - cos_t1 * cos_t1).astype(np.float32)
    ours = tfres.refl_coefs(t_rows, torch.as_tensor(cos_t1),
                            torch.as_tensor(sin_t1))
    ref = jfres.refl_coefs(j_rows, jnp.asarray(cos_t1), jnp.asarray(sin_t1))
    for a, b in zip(ours, ref):
        _close(a, b)


def test_complex_sqrt_matches(rng):
    re = rng.normal(size=1024).astype(np.float32) * 10
    im = rng.normal(size=1024).astype(np.float32) * 10
    im[:64] = 0.0
    mag = np.sqrt(re * re + im * im).astype(np.float32)
    ours = tfres.complex_sqrt(*map(torch.as_tensor, (re, im, mag)))
    ref = jfres.complex_sqrt(*map(jnp.asarray, (re, im, mag)))
    for a, b in zip(ours, ref):
        _close(a, b)


def test_scat_coefs_match(rng):
    n = 4096
    th_s = rng.uniform(0, np.pi, n).astype(np.float32)
    th_i = rng.uniform(0, np.pi / 2, n).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    a = rng.integers(1, 5, n).astype(np.float32)
    ours = scat_coefs(*map(torch.as_tensor, (th_s, th_i, s, a)))
    ref = jax_scat(*map(jnp.asarray, (th_s, th_i, s, a)))
    for x, y in zip(ours, ref):
        _close(x, y)
    # with the dot products handed in, as the tracer does
    cos_ts, cos_ti = np.cos(th_s), np.cos(th_i)
    sin_ti = np.sin(th_i)
    ours = scat_coefs(*map(torch.as_tensor, (th_s, th_i, s, a, cos_ts,
                                             cos_ti, sin_ti)))
    ref = jax_scat(*map(jnp.asarray, (th_s, th_i, s, a)),
                   cos_ts=jnp.asarray(cos_ts), cos_ti=jnp.asarray(cos_ti),
                   sin_ti=jnp.asarray(sin_ti))
    for x, y in zip(ours, ref):
        _close(x, y)


def test_config_validation():
    TracerConfig(backend="cuda")
    TracerConfig(backend="torch")
    for bad in (dict(parity="bogus"), dict(num_paths=0),
                dict(backend="pallas"), dict(rx_query_rays=0),
                dict(launch_order="random"), dict(ray_chunk=0)):
        with pytest.raises(ValueError):
            TracerConfig(**bad)
    with pytest.raises(TypeError):   # knobs not ported are not accepted
        TracerConfig(precision="exact1")
    TracerConfig(tri_shard_table=True)
    with pytest.raises(ValueError):  # as the JAX package: False, True, auto
        TracerConfig(tri_shard_table="sharded")
    with pytest.raises(ValueError):  # as the JAX package: physical only
        TracerConfig(transmission=True)
    assert TracerConfig().resolved_launch_order == "fibonacci"
    assert (TracerConfig(parity="physical").resolved_launch_order
            == "coherent")
