"""PyTorch port vs JAX package: the reflection-half shading (``shade="pallas"``).

``shade_a_plain`` (the plain version of the shading kernel,
``csrc/shade.cu``: the op path's ``shade_a`` on the kernel's operands) is
held against the JAX package's Pallas ``shade_a`` (interpret mode) and its
jnp reference ``shade_a_jnp`` on ~700 seeded rays that hit triangles of a
procedural scene (a dense soup; the canyon ``.hrt`` is not needed), none
closer to grazing than |n.d| = 0.01 (there the hit distance's f32 rounding
error grows as 1 / |n.d|, and XLA on the CPU rounds otherwise, contracting
products into FMAs, where the port rounds each product as torch does): a dead
ray keeps its inputs bit for bit on both sides, every value within 3e-5 of
its row's largest magnitude (``tests/test_bounce_fused.py``'s tier), a
complex value's (re, im) rows and a vector's components taken together.
``ShadeAFn``'s backward (``torch.func.vjp`` of the plain version, on the
CPU) is held against ``jax.vjp`` of JAX's ``shade_a`` (its custom vjp) on
random cotangents, with and without the geometry's cotangent, to the same
tier of each row plus 1e-16, except where the port is nearer than JAX to the
float64 evaluation of the plain chain (a near-grazing hit's vertex
cotangents, where f32 rounding orders part: at most 1% of the rays).  The
kernel itself is tested on the card by ``tests/test_torch_cuda.py``."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.ops.fresnel import precompute_eta as jax_eta
from hermespy_rt_tpu.ops.shade import ETA_FIELDS, shade_a, shade_a_jnp
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.ops.shade import shade_a_plain
from hermespy_rt_tpu_torch.ops.shade_cuda import ShadeAFn

AMP, VEC = checks.AMP_GROUPS, checks.VEC_GROUPS
GEO_KEYS = ("v0", "e1", "e2", "normal", "velocity")
R = 701
FREQ = np.float32(3.0)
C0 = np.float32(299792458.0)


def _inputs(seed=0):
    """Rays that hit a random triangle of a dense soup at 1-30 m, not
    closer to grazing than |n.d| = 0.01, 80% live; the payload rows
    (geometry, a velocity per triangle, the eta row of its material at 3
    GHz) as the tracer fetches them."""
    rng = np.random.default_rng(seed)
    soa = js.flatten_scene(js.random_soup_scene(120, seed=5, extent=10.0,
                                                tri_size=2.0))
    vel = rng.uniform(-2.0, 2.0, soa.velocity.shape).astype(np.float32)
    soa = dataclasses.replace(soa, velocity=jnp.asarray(vel))
    eta = jax_eta(jax_materials(), FREQ)
    tri = rng.integers(0, soa.num_triangles, R)
    mat = np.asarray(soa.material)[tri]
    geo = np.concatenate([np.asarray(getattr(soa, k))[tri] for k in GEO_KEYS],
                         axis=1)
    row = np.concatenate([geo, np.stack([np.asarray(getattr(eta, f))[mat]
                                         for f in ETA_FIELDS], axis=1)],
                         axis=1).astype(np.float32)
    u, v = rng.uniform(size=(2, R))
    flip = u + v > 1.0
    u, v = np.where(flip, 1.0 - u, u), np.where(flip, 1.0 - v, v)
    p = geo[:, 0:3] + u[:, None] * geo[:, 3:6] + v[:, None] * geo[:, 6:9]
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = geo[:, 9:12]
    while (grazing := np.abs((n * d).sum(1)) < 0.01).any():
        d[grazing] = rng.normal(size=(int(grazing.sum()), 3))
        d[grazing] /= np.linalg.norm(d[grazing], axis=1, keepdims=True)
    o = p - rng.uniform(1.0, 30.0, (R, 1)) * d
    st = rng.normal(size=(6, R)).astype(np.float32)
    st[4] = rng.uniform(0.0, 1e-6, R)
    f_hz = FREQ * np.float32(1e9)
    sc = np.array([np.float32(4.0) * np.float32(np.pi) * f_hz / C0,
                   f_hz / C0], np.float32)
    live = rng.uniform(size=R) < 0.8
    return (o.astype(np.float32), d.astype(np.float32), st, live, row, sc)


def _jax_args(o, d, st, live, row, sc):
    hit = {k: jnp.asarray(row[:, 3 * i:3 * i + 3])
           for i, k in enumerate(GEO_KEYS)}
    eta = type(jax_eta(jax_materials(), FREQ))(**{
        f: jnp.asarray(row[:, 15 + i]) for i, f in enumerate(ETA_FIELDS)})
    return (jnp.asarray(o), jnp.asarray(d), *map(jnp.asarray, st),
            jnp.asarray(live), hit, eta, jnp.float32(sc[0]),
            jnp.float32(sc[1]))


def _as_kernel_outputs(out):
    """JAX's 11 outputs as the kernel's (o2, d2, st2, ex[:3])."""
    return (np.asarray(out[0]), np.asarray(out[1]),
            np.stack([np.asarray(x) for x in out[2:8]]),
            np.stack([np.asarray(x) for x in out[8:11]]))


def _hold(ours, ref, label):
    o2, d2, st2, ex = (x.detach() if isinstance(x, torch.Tensor)
                       else torch.as_tensor(x) for x in ours)
    r_o2, r_d2, r_st2, r_ex = map(torch.as_tensor, ref)
    checks.rows_close(o2.T, r_o2.T, checks.ROW_RTOL, f"{label} o2", VEC)
    checks.rows_close(d2.T, r_d2.T, checks.ROW_RTOL, f"{label} d2", VEC)
    checks.rows_close(st2, r_st2, checks.ROW_RTOL, f"{label} st2", AMP)
    checks.rows_close(ex[:3], r_ex, checks.ROW_RTOL, f"{label} ex")


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_shade_plain_matches_jax(ref):
    args = _inputs()
    o, d, st, live, row, sc = args
    fn = shade_a if ref == "pallas" else shade_a_jnp
    ref_out = _as_kernel_outputs(fn(*_jax_args(*args)))
    ours = shade_a_plain(*map(torch.as_tensor, args))
    assert [tuple(x.shape) for x in ours] == [(R, 3), (R, 3), (6, R), (5, R)]
    dead = ~live
    assert dead.any() and live.any()
    for x, x0 in ((ours[0], o), (ours[1], d), (ours[2][:4].T, st[:4].T)):
        np.testing.assert_array_equal(x.numpy()[dead], x0[dead])
    for x, x0 in ((ref_out[0], o), (ref_out[1], d), (ref_out[2][:4].T,
                                                      st[:4].T)):
        np.testing.assert_array_equal(x[dead], x0[dead])
    _hold(ours, ref_out, f"shade_a vs JAX {ref}")
    # the CPU wrapper runs the plain version
    again = checks.KERNELS["shade_a"](*map(torch.as_tensor, args))
    assert all(torch.equal(a, b) for a, b in zip(again, ours))


@pytest.mark.parametrize("grad_geometry", [True, False])
def test_shade_fn_grads_match_jax_vjp(grad_geometry):
    args = _inputs(seed=1)
    o, d, st, live, row, sc = args
    rng = np.random.default_rng(2)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((R, 3), (R, 3), (6, R), (3, R))]
    jargs = _jax_args(*args)
    _, vjp = jax.vjp(lambda *a: shade_a(*a[:8], jargs[8], *a[8:]),
                     *jargs[:8], *jargs[9:])
    g = vjp((jnp.asarray(cots[0]), jnp.asarray(cots[1]),
             *map(jnp.asarray, cots[2]), *map(jnp.asarray, cots[3])))
    ref = dict(o=g[0], d=g[1], st=np.stack([np.asarray(x) for x in g[2:8]]),
               geo=np.concatenate([np.asarray(g[8][k]) for k in GEO_KEYS], 1),
               eta=np.stack([np.asarray(getattr(g[9], f))
                             for f in ETA_FIELDS], 1),
               sc=np.array([g[10], g[11]]))

    grads = {}
    for dt in (torch.float32, torch.float64):
        leaves = [torch.tensor(x, dtype=dt, requires_grad=True)
                  for x in (o, d, st, row, sc)]
        out = ShadeAFn.apply(*leaves[:3], torch.as_tensor(live), *leaves[3:],
                             grad_geometry)
        torch.autograd.backward(
            out, [torch.as_tensor(c, dtype=dt) for c in cots[:3]]
            + [torch.cat([torch.as_tensor(cots[3], dtype=dt),
                          torch.zeros(2, R, dtype=dt)])])
        grads[dt] = [x.grad for x in leaves]
    g32, g64 = grads[torch.float32], grads[torch.float64]
    n_nearer = 0

    def close(i, cols, ref_rows, label, groups=None, transpose=True):
        nonlocal n_nearer
        ours, exact = (g[i][cols].double() for g in (g32, g64))
        if transpose:
            ours, exact = ours.T, exact.T
        ref_rows = torch.as_tensor(np.array(ref_rows, np.float64))
        _, bad = checks._beyond(ours, ref_rows, checks.ROW_RTOL, groups,
                                checks.LEAF_ATOL)
        nearer = (ours - exact).abs() <= (ref_rows - exact).abs()
        n_nearer += int((bad & nearer).sum())
        checks.rows_close(torch.where(nearer, ref_rows, ours), ref_rows,
                          checks.ROW_RTOL, label, groups,
                          atol=checks.LEAF_ATOL)

    every = (slice(None),)
    close(0, every, np.asarray(ref["o"]).T, "d_o", VEC)
    close(1, every, np.asarray(ref["d"]).T, "d_d", VEC)
    close(2, every, ref["st"], "d_st", AMP, transpose=False)
    close(3, (slice(None), slice(15, None)), ref["eta"].T, "d_eta")
    if grad_geometry:
        close(3, (slice(None), slice(0, 15)), ref["geo"].T, "d_geometry",
              tuple((c, c + 1, c + 2) for c in range(0, 15, 3)))
    else:
        assert not g32[3][:, :15].any()
    close(4, (slice(None), None), ref["sc"][:, None], "d_sc",
          transpose=False)
    assert n_nearer <= 0.01 * R
