"""PyTorch port vs JAX package: the transmission modes.

``tests/test_transmission.py``'s ten cases run on the port (procedural
walls, 64 paths, one or two bounces), each held against the JAX package on
the same scene.  Then the parts of the port that carry the modes are held
against their JAX counterparts on the same numpy inputs: ``trans_coefs`` on
a seeded angle x material grid (total internal reflection included, values
and gradients), ``_los_pass``, ``bounce_step`` and ``trace_paths`` under
``transmission`` and under ``spawn_transmission`` with both refractions, at
``shade="xla"`` and ``"pallas"`` (the JAX kernel in Pallas interpret mode,
the port's shading kernel through its plain version on the CPU), and their
material gradients against ``jax.grad``.  ``shade="fused"`` must warn under
either mode and give the op path's bits, and the fused loop must not read
the pattern carried in the launch state where no mode is set.  The fused
forward's stages (their plain versions, which the CPU runs) under
``transmission``, ``spawn_transmission`` with straight refraction and both
must make ``bounce_step``'s decisions and geometry per bounce, its values
within the fused tier, and a trace through them must agree with JAX.

Tolerances are ``tests/test_torch_tracer.py``'s: the written slots of every
output identical, written values within rtol 1e-4 with a floor of 1e-5 of
the largest magnitude; gradients within rtol 1e-4 of ``jax.grad``."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu as J
import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu import tracer as jt
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.ops import fresnel as jf
import hermespy_rt_tpu_torch as hrt
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch import tracer as tt
from hermespy_rt_tpu_torch.convert import soa_from_jax
from hermespy_rt_tpu_torch.ops.bounce_fused import (bounce_post_plain,
                                                    bounce_pre_plain)
from hermespy_rt_tpu_torch.materials import (MATERIAL_FIELDS, MATERIAL_METAL,
                                             MaterialTable, default_materials)
from hermespy_rt_tpu_torch.ops import fresnel as tf
from hermespy_rt_tpu_torch.scene import HostMesh, HostScene, flatten_scene

QUAD = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
CFG = dict(num_paths=64, num_bounces=1, keep_rays=False)
MODES = {"transmission": dict(transmission=True),
         "spawn_straight": dict(spawn_transmission=True),
         "spawn_snell": dict(spawn_transmission=True, refraction="snell")}


def _wall_x(x, material, size=10.0):
    vs = np.array([[x, -size, -size], [x, size, -size], [x, size, size],
                   [x, -size, size]], np.float32)
    return vs, material


def _plate_z(z, material, size):
    vs = np.array([[-size, -size, z], [size, -size, z], [size, size, z],
                   [-size, size, z]], np.float32)
    return vs, material


def _scenes(quads):
    """The same quads as a JAX host scene and a port host scene."""
    return (js.HostScene([js.HostMesh(v, QUAD, material_index=m)
                          for v, m in quads]),
            HostScene([HostMesh(v, QUAD, material_index=m)
                       for v, m in quads]))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(ref, ours, label, vec=False):
    """Identical written slots, written values within rtol 1e-4 and 1e-5 of
    the largest magnitude."""
    ref, ours = np.asarray(ref), _np(ours)
    assert ref.shape == ours.shape, f"{label}: {ref.shape} vs {ours.shape}"
    w_ref, w_our = np.abs(ref) > 0, np.abs(ours) > 0
    if vec:
        w_ref, w_our = w_ref.any(-1), w_our.any(-1)
    np.testing.assert_array_equal(w_our, w_ref, err_msg=f"{label}: masks")
    if w_ref.any():
        np.testing.assert_allclose(ours[w_ref], ref[w_ref], rtol=1e-4,
                                   atol=np.abs(ref[w_ref]).max() * 1e-5,
                                   err_msg=label)


def _close_paths(ref, ours, rays=False):
    for part in ("los", "scatter"):
        for f in ("a_te", "a_tm", "tau", "freq_shift"):
            _close(getattr(getattr(ref, part), f),
                   getattr(getattr(ours, part), f), f"{part}.{f}")
        for f in ("directions_rx", "directions_tx"):
            _close(getattr(getattr(ref, part), f),
                   getattr(getattr(ours, part), f), f"{part}.{f}", vec=True)
    np.testing.assert_array_equal(_np(ours.los_blocked),
                                  np.asarray(ref.los_blocked))
    if rays:
        for part in ("rays_los", "rays_scatter"):
            r_ref, r_our = getattr(ref, part), getattr(ours, part)
            act = np.asarray(r_ref.active)
            np.testing.assert_array_equal(_np(r_our.active), act, part)
            for f in ("origins", "directions"):
                a = np.asarray(getattr(r_ref, f))
                np.testing.assert_allclose(_np(getattr(r_our, f))[act],
                                           a[act], rtol=1e-4,
                                           atol=np.abs(a).max() * 1e-5,
                                           err_msg=f"{part}.{f}")


def _both_trace(quads, rx, tx, rxv=None, txv=None, **kw):
    """``trace`` of the same scene and inputs on the JAX package
    (``backend="jnp"``) and on the port (``backend="torch"``, CPU)."""
    j_scene, t_scene = _scenes(quads)
    ref = J.trace(j_scene, rx, tx, rxv, txv, 3.0,
                  config=JaxConfig(backend="jnp", **kw))
    ours = hrt.trace(t_scene, rx, tx, rxv, txv, 3.0,
                     config=hrt.TracerConfig(backend="torch", **kw),
                     device="cpu")
    return ref, ours


# ---------------------------------------------------------------------------
# tests/test_transmission.py's ten cases on the port

@pytest.mark.parametrize("kw", [dict(transmission=True),
                                dict(spawn_transmission=True),
                                dict(parity="physical", refraction="snell")],
                         ids=["transmission", "spawn", "snell"])
def test_config_refuses_like_jax(kw):
    """transmission and spawn_transmission need physical parity; snell
    needs spawn_transmission (test_requires_physical_mode,
    test_spawn_requires_physical_mode, test_snell_requires_spawn)."""
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        hrt.TracerConfig(**kw)


def _los_through_wall(material, transmission):
    ref, ours = _both_trace([_wall_x(0.0, material)], [[3.0, 0.0, 0.0]],
                            [[-3.0, 0.0, 0.0]], parity="physical",
                            transmission=transmission, **CFG)
    _close_paths(ref, ours)
    return (complex(ours.los.a_te[0, 0, 0].detach()),
            float(ours.los.tau[0, 0, 0]))


def test_los_penetration_loss():
    a_off, tau_off = _los_through_wall(1, False)
    assert a_off == 0.0 and tau_off == 0.0
    a_on, tau_on = _los_through_wall(1, True)
    assert 0 < abs(a_on)
    assert tau_on > 0
    free, _ = _los_through_wall(0, True)   # an "air" wall
    assert abs(a_on) < abs(free) * 1.001


def test_metal_wall_nearly_opaque():
    a_metal, _ = _los_through_wall(MATERIAL_METAL, True)
    a_concrete, _ = _los_through_wall(1, True)
    assert abs(a_metal) < 0.05 * abs(a_concrete)


def test_scatter_shadow_transmission():
    """A reflector behind a wall still contributes attenuated paths."""
    quads = [_plate_z(0.0, 1, 0.5), _plate_z(1.0, 4, 5.0)]
    rx, tx = [[0.0, 0.0, 2.0]], [[0.0, 0.0, 0.5]]
    _, base = _both_trace(quads, rx, tx, parity="physical", **CFG)
    ref, trans = _both_trace(quads, rx, tx, parity="physical",
                             transmission=True, **CFG)
    _close_paths(ref, trans)
    a0, a1 = _np(base.scatter.a_te), _np(trans.scatter.a_te)
    assert ((np.abs(a1) > 0) & (np.abs(a0) == 0)).sum() > 3
    assert np.isfinite(a1).all()


def test_transmission_differentiable():
    j_scene, t_scene = _scenes([_wall_x(0.0, 1)])
    rx = np.array([[3.0, 0.0, 0.0]], np.float32)
    tx = np.array([[-3.0, 0.0, 0.0]], np.float32)
    z = np.zeros((1, 3), np.float32)
    cfg = dict(parity="physical", transmission=True, **CFG)
    j_tris = js.flatten_scene(j_scene)

    def jax_loss(mats):
        res = jt.trace_paths(j_tris, mats, rx, tx, z, z, 3.0,
                             JaxConfig(backend="jnp", **cfg))
        return jnp.sum(jnp.abs(res.los.a_te) ** 2) * 1e6

    g_ref = jax.jit(jax.grad(jax_loss))(jax_materials())
    mats = default_materials("cpu")
    res = tt.trace_paths(flatten_scene(t_scene, device="cpu"), mats, rx, tx,
                         z, z, 3.0, hrt.TracerConfig(backend="torch", **cfg))
    (res.los.a_te.abs().square().sum() * 1e6).backward()
    ga = mats.a.grad.numpy()
    assert np.isfinite(ga).all()
    assert abs(ga[1]) > 0      # the concrete wall's permittivity matters
    np.testing.assert_allclose(ga, np.asarray(g_ref.a), rtol=1e-4,
                               atol=np.abs(np.asarray(g_ref.a)).max() * 1e-5)


def test_spawn_pattern_zero_rays_unchanged():
    """Pure-reflection rays equal a trace without spawning bit for bit, and
    transmitted rays reach an RX behind the wall that reflection cannot."""
    P = 128
    quads = [_wall_x(0.0, 1)]
    rx, tx = [[3.0, 4.0, 1.0]], [[-3.0, 0.0, 0.0]]
    kw = dict(num_paths=P, num_bounces=1, parity="physical", keep_rays=False)
    _, r0 = _both_trace(quads, rx, tx, **kw)
    ref, r1 = _both_trace(quads, rx, tx, spawn_transmission=True, **kw)
    _close_paths(ref, r1)
    a0, a1 = _np(r0.scatter.a_te)[0, 0], _np(r1.scatter.a_te)[0, 0]
    even = np.arange(P) % 2 == 0
    np.testing.assert_array_equal(a1[even], a0[even])
    assert np.all(a0 == 0)
    assert np.count_nonzero(a1[~even]) > 10


def _two_walls():
    return [_wall_x(1.0, 1), _wall_x(3.0, 1)]


def test_spawn_refracted_continuation_geometry():
    """TX -> through wall A -> wall B -> RX: the TR ray scatters between the
    walls, the TT ray behind B, |TT/TR| = |T/R| of wall B at normal
    incidence (zero-width lobe, mirrored RX pair)."""
    j_scene, t_scene = _scenes(_two_walls())
    jm = jax_materials()
    jm = dataclasses.replace(jm, s1_alpha=jnp.zeros_like(jm.s1_alpha))
    cols = {f: np.asarray(getattr(jm, f)) for f in MATERIAL_FIELDS}
    tx = np.zeros((1, 3), np.float32)
    rx = np.array([[2.0, 5.0, 0.0], [4.0, 5.0, 0.0]], np.float32)
    z1, z2 = np.zeros((1, 3), np.float32), np.zeros((2, 3), np.float32)
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    kw = dict(num_paths=4, num_bounces=2, parity="physical", keep_rays=False,
              spawn_transmission=True)
    ref = jt.trace_paths(js.flatten_scene(j_scene), jm, rx, tx, z2, z1, 3.0,
                         JaxConfig(backend="jnp", **kw),
                         launch_dirs=jnp.asarray(dirs))
    res = tt.trace_paths(flatten_scene(t_scene, device="cpu"),
                         MaterialTable(cols, device="cpu"), rx, tx, z2, z1,
                         3.0, hrt.TracerConfig(backend="torch", **kw),
                         launch_dirs=torch.as_tensor(dirs))
    _close_paths(ref, res)
    a = _np(res.scatter.a_te)[:, 0]
    tau = _np(res.scatter.tau)[:, 0]
    b2 = a[:, 4:]
    assert np.all(b2[:, 0] == 0.0)
    assert abs(b2[0, 1]) > 0 and b2[1, 1] == 0.0
    np.testing.assert_allclose(tau[0, 5], (3.0 + np.sqrt(26.0))
                               / tt.SPEED_OF_LIGHT, rtol=1e-3)
    assert abs(b2[1, 3]) > 0 and b2[0, 3] == 0.0
    eta_all = tf.precompute_eta(MaterialTable(cols, device="cpu"), 3.0)
    eta = tf.EtaPrecomputed(**{f: getattr(eta_all, f)[1:2]
                               for f in tf.ETA_FIELDS})
    c1 = torch.tensor([1.0 - 1.1920929e-07])
    s1 = torch.sqrt(1.0 - c1 * c1)
    rr, tr_ = tf.refl_coefs(eta, c1, s1), tf.trans_coefs(eta, c1, s1)
    R = complex(float(rr[0][0].detach()), float(rr[1][0].detach()))
    T = complex(float(tr_[0][0].detach()), float(tr_[1][0].detach()))
    np.testing.assert_allclose(abs(b2[1, 3] / b2[0, 1]), abs(T / R),
                               rtol=1e-3)
    assert abs(a[0, 1]) > 0
    np.testing.assert_allclose(tau[0, 1], (1.0 + np.sqrt(26.0))
                               / tt.SPEED_OF_LIGHT, rtol=1e-3)


def test_snell_refraction_bends_continuation():
    """snell bends the transmitted ray: sin t2 = sin t1 / n, unit norm,
    tangential direction kept; straight passes through; the reflected ray
    is the same in both; the bent direction is differentiable in eta."""
    j_scene, t_scene = _scenes([_wall_x(0.0, 1)])
    t_tris = flatten_scene(t_scene, device="cpu")
    tx = np.array([[-3.0, 3.0, 0.0]], np.float32)
    rx = np.array([[3.0, 4.0, 1.0]], np.float32)
    z = np.zeros((1, 3), np.float32)
    d0 = np.array([1.0, 1.0, 0.0], np.float32) / np.float32(np.sqrt(2.0))
    dirs = np.tile(d0, (2, 1))
    kw = dict(num_paths=2, num_bounces=1, parity="physical", keep_rays=True,
              spawn_transmission=True)

    def bounce1_dir(refraction, mats=None):
        held = mats is None       # held against JAX on the default table
        mats = default_materials("cpu") if held else mats
        res = tt.trace_paths(t_tris, mats, rx, tx, z, z, 3.0,
                             hrt.TracerConfig(refraction=refraction,
                                              backend="torch", **kw),
                             launch_dirs=torch.as_tensor(dirs))
        ref = jt.trace_paths(js.flatten_scene(j_scene), jax_materials(), rx,
                             tx, z, z, 3.0,
                             JaxConfig(refraction=refraction, backend="jnp",
                                       **kw), launch_dirs=jnp.asarray(dirs))
        if held:
            _close_paths(ref, res, rays=True)
        return res.rays_scatter.directions[0, 1]

    d_straight = _np(bounce1_dir("straight"))
    np.testing.assert_allclose(d_straight[1], d0, atol=1e-6)
    d_snell = _np(bounce1_dir("snell"))
    d_t = d_snell[1]
    assert np.isclose(np.linalg.norm(d_t), 1.0, rtol=1e-5)
    n_med = float(tf.precompute_eta(default_materials("cpu"), 3.0)
                  .eta_sqrt_re[1].detach())
    np.testing.assert_allclose(np.linalg.norm(d_t[1:]), np.sqrt(0.5) / n_med,
                               rtol=1e-5)
    assert d_t[0] > 0 and d_t[1] > 0 and abs(d_t[2]) < 1e-6
    np.testing.assert_array_equal(d_snell[0], d_straight[0])
    mats = default_materials("cpu")
    bounce1_dir("snell", mats)[1, 1].backward()
    g = float(mats.a.grad[1])
    assert np.isfinite(g) and g != 0.0


# ---------------------------------------------------------------------------
# the port's parts against the JAX package's on the same inputs

def test_trans_coefs_matches_jax():
    """Values and gradients (to the material parameters and the angles) on
    a seeded angle x material grid; grazing angles on near-air materials
    reach the total-internal-reflection branch."""
    rng = np.random.default_rng(7)
    jm = jax_materials()
    cols = {f: np.asarray(getattr(jm, f)) for f in MATERIAL_FIELDS}
    M = cols["a"].shape[0]
    cos = np.concatenate([rng.uniform(0.0, 1.0, 40),
                          [0.0, 1e-4, 0.5, 1.0 - 1.1920929e-07]]
                         ).astype(np.float32)
    mat = np.repeat(np.arange(M), cos.size)
    cos = np.tile(cos, M)
    sin = np.sqrt(1.0 - cos * cos).astype(np.float32)
    w = rng.normal(size=(4, cos.size)).astype(np.float32)

    def jax_fn(mats, c, s):
        eta = jf.precompute_eta(mats, 3.0)
        rows = jax.tree.map(lambda x: x[mat], eta)
        out = jf.trans_coefs(rows, c, s)
        return sum(jnp.sum(wi * o) for wi, o in zip(w, out)), out

    (_, out_j), g_j = jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                         has_aux=True)(
        jm, jnp.asarray(cos), jnp.asarray(sin))
    mats = MaterialTable(cols, device="cpu")
    c = torch.tensor(cos, requires_grad=True)
    s = torch.tensor(sin, requires_grad=True)
    eta = tf.precompute_eta(mats, 3.0)
    rows = tf.EtaPrecomputed(**{f: getattr(eta, f)[torch.as_tensor(mat)]
                                for f in tf.ETA_FIELDS})
    out = tf.trans_coefs(rows, c, s)
    tir = _np(rows.eta_abs_inv_sqrt * s > 1.0 - 1.1920929e-07)
    assert tir.any() and not tir.all()
    for k, (a, b) in enumerate(zip(out_j, out)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=f"output {k}")
        assert (_np(b)[tir] == 0).all()
    sum((torch.as_tensor(wi) * o).sum() for wi, o in zip(w, out)).backward()
    g_mats, g_c, g_s = g_j
    for f in MATERIAL_FIELDS:
        ref = np.asarray(getattr(g_mats, f))
        got = (np.zeros_like(ref) if getattr(mats, f).grad is None
               else getattr(mats, f).grad.numpy())
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=np.abs(ref).max() * 1e-5 + 1e-30,
                                   err_msg=f)
    for got, ref, name in ((c.grad, g_c, "cos"), (s.grad, g_s, "sin")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=1e-4,
                                   atol=np.abs(ref).max() * 1e-5,
                                   err_msg=name)


# a corridor: concrete wall A (x = 1), wood wall B (x = 3), a brick floor
CORRIDOR = [_wall_x(1.0, 1), _wall_x(3.0, 4), _plate_z(-1.0, 2, 10.0)]
C_RX = np.array([[2.0, 0.5, 0.2], [4.0, 1.0, 0.5], [-1.0, 2.0, 0.3]],
                np.float32)
C_TX = np.array([[0.0, 0.0, 0.0]], np.float32)
C_RXV = np.array([[1.0, 2.0, 0.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.5]],
                 np.float32)
C_TXV = np.array([[0.5, -1.0, 0.25]], np.float32)


def _corridor():
    j_scene, _ = _scenes(CORRIDOR)
    soa = js.flatten_scene(j_scene)
    return soa, soa_from_jax(vars(soa))


def _cfgs(mode, shade, **kw):
    kw = {**dict(num_paths=64, num_bounces=2, parity="physical", shade=shade,
                 **MODES[mode]), **kw}
    return JaxConfig(backend="jnp", **kw), hrt.TracerConfig(backend="torch",
                                                             **kw)


def _scalars(f_ghz=3.0):
    f_hz = np.float32(f_ghz) * np.float32(1e9)
    fslm = np.float32(4.0) * jt.PI * f_hz / jt.SPEED_OF_LIGHT
    return fslm, f_hz / jt.SPEED_OF_LIGHT


def _accesses(mode, shade):
    soa, tris = _corridor()
    jcfg, tcfg = _cfgs(mode, shade)
    j_acc = jt.LocalSceneAccess(soa, None, jcfg,
                                eta=jf.precompute_eta(jax_materials(), 3.0))
    mats = default_materials("cpu")
    t_acc = tt.LocalSceneAccess(tris, tcfg, tf.precompute_eta(mats, 3.0))
    return j_acc, t_acc, jcfg, tcfg


@pytest.mark.parametrize("shade", ["xla", "pallas"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_los_pass_matches_jax(mode, shade):
    j_acc, t_acc, jcfg, tcfg = _accesses(mode, shade)
    fslm, k_dop = _scalars()
    los_j, _, blocked_j = jt._los_pass(j_acc, C_RX, C_TX, C_RXV, C_TXV,
                                       fslm, k_dop, jcfg)
    los_t, _, blocked_t = tt._los_pass(
        t_acc, *(torch.as_tensor(x) for x in (C_RX, C_TX, C_RXV, C_TXV)),
        torch.tensor(fslm), torch.tensor(k_dop), tcfg)
    np.testing.assert_array_equal(_np(blocked_t), np.asarray(blocked_j))
    assert _np(blocked_t).any()
    for f in ("a_te", "a_tm", "tau", "freq_shift"):
        _close(getattr(los_j, f), getattr(los_t, f), f)
    if jcfg.transmission:   # a blocked LoS keeps a penetration-loss gain
        assert (np.abs(_np(los_t.a_te))[_np(blocked_t)] > 0).all()


@pytest.mark.parametrize("shade", ["xla", "pallas"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bounce_step_matches_jax(mode, shade):
    """Two bounces from the launch state: the carried state (the pattern
    word shifted once a bounce) and each bounce's outputs."""
    j_acc, t_acc, jcfg, tcfg = _accesses(mode, shade)
    fslm, k_dop = _scalars()
    dirs = np.asarray(tt.launch_directions(64, "coherent", "cpu"))
    pat = (np.arange(64) % 4).astype(np.int32) if jcfg.spawn_transmission \
        else None
    carry = jt.launch_state(jnp.asarray(C_TX), jnp.asarray(C_TXV),
                            jnp.asarray(dirs), k_dop, transmit_pattern=pat)
    state = tt.launch_state(torch.as_tensor(C_TX), torch.as_tensor(C_TXV),
                            torch.as_tensor(dirs), torch.tensor(k_dop),
                            transmit_pattern=pat)
    rx = torch.as_tensor(C_RX)
    for b in range(2):
        carry, ys_j = jt.bounce_step(carry, None, access=j_acc,
                                     rx_pos=jnp.asarray(C_RX), fslm=fslm,
                                     k_dop=k_dop, cfg=jcfg)
        state, ys_t = tt.bounce_step(state, access=t_acc, rx_pos=rx,
                                     fslm=torch.tensor(fslm),
                                     k_dop=torch.tensor(k_dop), cfg=tcfg)
        names = ("te_re", "te_im", "tm_re", "tm_im", "tau", "freq")
        for name, a, c in zip(names, ys_j[:6], ys_t[:6]):
            _close(a, c, f"bounce {b} {name}")
        _close(ys_j[6], ys_t[6], f"bounce {b} dir_rx", vec=True)
        np.testing.assert_array_equal(_np(state[7]), np.asarray(carry[7]))
        np.testing.assert_array_equal(_np(state[9]), np.asarray(carry[10]))
        live = _np(state[7])
        for k in (0, 1):
            np.testing.assert_allclose(_np(state[k])[live],
                                       np.asarray(carry[k])[live], rtol=1e-4,
                                       atol=1e-5 * np.abs(carry[k]).max())
        for k in (2, 3, 4, 5, 6, 8):
            _close(carry[k], state[k], f"bounce {b} state {k}")
        if pat is None:
            assert state[10] is None
        else:
            np.testing.assert_array_equal(_np(state[10]),
                                          np.asarray(carry[9]))
            np.testing.assert_array_equal(_np(state[10]), pat >> (b + 1))


def _both_paths(mode, shade, mats_j=None, mats_t=None, **kw):
    soa, tris = _corridor()
    jcfg, tcfg = _cfgs(mode, shade, **kw)
    mats_j = jax_materials() if mats_j is None else mats_j
    mats_t = default_materials("cpu") if mats_t is None else mats_t
    ref = jt.trace_paths(soa, mats_j, C_RX, C_TX, C_RXV, C_TXV, 3.0, jcfg)
    ours = tt.trace_paths(tris, mats_t, C_RX, C_TX, C_RXV, C_TXV, 3.0, tcfg)
    return ref, ours


@pytest.mark.parametrize("shade", ["xla", "pallas"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_trace_matches_jax(mode, shade):
    ref, ours = _both_paths(mode, shade, keep_rays=True)
    _close_paths(ref, ours, rays=True)
    assert (np.abs(_np(ours.scatter.a_te)) > 0).sum() > 40


def _loss_t(res):
    return ((res.scatter.a_te.abs().square().sum()
             + res.scatter.a_tm.abs().square().sum()
             + res.los.a_te.abs().square().sum()) * 1e6)


# shade="pallas" differentiates the same torch chain as "xla" (its kernel
# only replaces the forward), which tests/test_torch_shade.py holds
@pytest.mark.parametrize("mode,shade", [("transmission", "xla"),
                                        ("spawn_snell", "xla")])
def test_material_gradients_match_jax(mode, shade):
    soa, tris = _corridor()
    jcfg, tcfg = _cfgs(mode, shade, keep_rays=False, num_bounces=1)

    def jax_loss(mats):
        res = jt.trace_paths(soa, mats, C_RX, C_TX, C_RXV, C_TXV, 3.0, jcfg)
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
                + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)
                + jnp.sum(jnp.abs(res.los.a_te) ** 2)) * 1e6

    g_ref = jax.jit(jax.grad(jax_loss))(jax_materials())
    mats = default_materials("cpu")
    _loss_t(tt.trace_paths(tris, mats, C_RX, C_TX, C_RXV, C_TXV, 3.0,
                           tcfg)).backward()
    assert np.abs(np.asarray(g_ref.a)).max() > 0
    for f in MATERIAL_FIELDS:
        p = getattr(mats, f)
        g = torch.zeros_like(p) if p.grad is None else p.grad
        ref = np.asarray(getattr(g_ref, f))
        assert torch.isfinite(g).all(), f
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=np.abs(ref).max() * 1e-5 + 1e-30,
                                   err_msg=f)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_warns_and_equals_op_path(mode):
    soa, tris = _corridor()
    _, tcfg = _cfgs(mode, "xla", keep_rays=True)
    out = {}
    for shade in ("xla", "fused"):
        cfg = dataclasses.replace(tcfg, shade=shade)
        mats = default_materials("cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            if shade == "fused":
                with pytest.warns(UserWarning, match="transmission modes"):
                    res = tt.trace_paths(tris, mats, C_RX, C_TX, C_RXV,
                                         C_TXV, 3.0, cfg)
            else:
                res = tt.trace_paths(tris, mats, C_RX, C_TX, C_RXV, C_TXV,
                                     3.0, cfg)
        _loss_t(res).backward()
        out[shade] = (res, [getattr(mats, f).grad for f in MATERIAL_FIELDS])
    (r_x, g_x), (r_f, g_f) = out["xla"], out["fused"]
    for part in ("los", "scatter"):
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
            assert torch.equal(getattr(getattr(r_x, part), f),
                               getattr(getattr(r_f, part), f)), f
    for part in ("origins", "directions", "active"):
        assert torch.equal(getattr(r_x.rays_scatter, part),
                           getattr(r_f.rays_scatter, part))
    for a, b in zip(g_x, g_f):
        assert (a is None and b is None) or torch.equal(a, b)


def test_fused_loop_ignores_the_pattern():
    """The fused loop reads the launch state's first ten fields: a pattern
    word carried after them leaves every output and the material gradient
    bit for bit as without it."""
    _, tris = _corridor()
    cfg = hrt.TracerConfig(num_paths=64, num_bounces=2, parity="reference",
                           shade="fused", grad_positions=False,
                           grad_geometry=False, keep_rays=True)
    rx = torch.as_tensor(C_RX)
    fslm, k_dop = (torch.tensor(x) for x in _scalars())
    dirs = tt.launch_directions(64, "fibonacci", "cpu")
    outs = []
    for pat in (None, tt.transmit_patterns(64, 2)):
        mats = default_materials("cpu")
        access = tt.LocalSceneAccess(tris, cfg, tf.precompute_eta(mats, 3.0))
        state = tt.launch_state(torch.as_tensor(C_TX), torch.as_tensor(C_TXV),
                                dirs, k_dop, transmit_pattern=pat)
        assert len(state) == 11 and (state[10] is None) == (pat is None)
        plan = tt.plan_bounce_loop(
            cfg, grad=True, device="cpu", tri_sharded=False, rays=64, nrx=3,
            n_materials=mats.num_materials)
        assert plan == tt.BouncePlan("fused_slim")
        ys = tt.run_fused_loop_slim(access, rx, state, fslm, k_dop, cfg)
        sum(y[0].square().sum() + y[2].square().sum() for y in ys).backward()
        outs.append((ys, mats.a.grad.clone(), mats.s.grad.clone()))
    (ys0, ga0, gs0), (ys1, ga1, gs1) = outs
    for y0, y1 in zip(ys0, ys1):
        for a, b in zip(y0, y1):
            assert torch.equal(a, b)
    assert torch.equal(ga0, ga1) and torch.equal(gs0, gs1)
    assert ga0.abs().max() > 0


@pytest.mark.parametrize("mode,shade,cull", [
    ("transmission", "xla", False), ("transmission", "pallas", False),
    ("transmission", "pallas", True), ("spawn_straight", "pallas", False),
    ("spawn_snell", "xla", False)])
def test_kernel_calls_of_a_step(mode, shade, cull):
    """The kernel wrappers a calibration step calls under each mode (their
    plain versions on the CPU), as ``testing.transmission_launches`` counts
    the launches the card run expects."""
    _, tris = _corridor()
    cfg = checks.transmission_config(64, 2, mode, shade=shade, cull=cull)
    with checks.recording_fused() as calls:
        checks.calibration_step(tris, C_RX, C_TX, 3.0,
                                default_materials("cpu"), cfg)
    want = checks.transmission_launches(cfg)
    for name in ("gather", "scatter_add", "shade_a", "nearest_hit_culled"):
        assert len(calls[name]) == want[name], name
    # the shadow blockers' rows: one gather of nrx x R ids a bounce
    if cfg.transmission:
        assert sum(args[1].numel() == 3 * 64 for args, _ in calls["gather"]
                   ) == 2


# the modes the fused forward takes: straight refraction only
FORWARD_MODES = {"transmission": dict(transmission=True),
                 "spawn_straight": dict(spawn_transmission=True),
                 "both": dict(transmission=True, spawn_transmission=True)}


def _fused_route(monkeypatch):
    """``plan_bounce_loop`` told that the rays are on a card, as the
    route tests do: the fused forward's route runs its plain stages."""
    real = tt.plan_bounce_loop
    monkeypatch.setattr(tt, "plan_bounce_loop",
                        lambda cfg, *, device, **kw: real(cfg, device="cuda",
                                                          **kw))


@pytest.mark.parametrize("mode", sorted(FORWARD_MODES))
def test_fused_forward_matches_op_path_and_jax(mode, monkeypatch):
    """Per bounce on the corridor, the fused forward's stages against
    ``bounce_step`` from the same launch state (the pattern words of
    ``transmit_patterns``): the decisions (live rays, their hits, the
    written (ray, RX)) and the bounced rays equal, the state and the six
    output rows within ``checks.ROW_RTOL`` of each row's largest; then a
    trace on the fused forward's route against JAX ``trace_paths(shade=
    "xla")`` at this file's tolerances."""
    flags = FORWARD_MODES[mode]
    _, tris = _corridor()
    cfg = hrt.TracerConfig(num_paths=64, num_bounces=3, parity="physical",
                           backend="torch", **flags)
    mats = default_materials("cpu")
    access = tt.LocalSceneAccess(tris, cfg, tf.precompute_eta(mats, 3.0))
    fslm, k_dop = (torch.tensor(x) for x in _scalars())
    rx = torch.as_tensor(C_RX)
    dirs = tt.launch_directions(64, "coherent", "cpu")
    pat = tt.transmit_patterns(64, 3) if cfg.spawn_transmission else None
    state = tt.launch_state(torch.as_tensor(C_TX), torch.as_tensor(C_TXV),
                            dirs, k_dop, transmit_pattern=pat)
    o, d, st, act, pidx = tt._launch_rows(state)
    spec = tt._fused_spec(cfg, len(C_RX))
    sc = torch.stack([fslm, k_dop])
    with torch.no_grad():
        stages = list(tt._fused_bounces(
            access, spec, cfg, rx, sc, access._table.detach(), st, o, d,
            act, pidx, bounce_pre_plain, bounce_post_plain, pat))
        for b, (pre, post) in enumerate(stages):
            state, ys = tt.bounce_step(state, access=access, rx_pos=rx,
                                       fslm=fslm, k_dop=k_dop, cfg=cfg)
            assert torch.equal(pre.live, state[7]), b
            assert torch.equal(pre.excl, state[9]), b
            assert torch.equal(pre.o2, state[0]) and torch.equal(
                pre.d2, state[1]), b
            checks.rows_close(pre.st2, torch.stack(state[2:7] + state[8:9]),
                              checks.ROW_RTOL, f"bounce {b} state",
                              checks.AMP_GROUPS)
            assert torch.equal(post.write, (ys[6] != 0).any(-1)), b
            checks.rows_close(post.out.reshape(-1, 64),
                              torch.stack(ys[:6], 1).reshape(-1, 64),
                              checks.ROW_RTOL, f"bounce {b} out")
    assert bool(stages[0][1].write.any())
    jcfg = JaxConfig(backend="jnp", num_paths=64, num_bounces=3,
                     parity="physical", keep_rays=True, **flags)
    soa, tris = _corridor()
    ref = jt.trace_paths(soa, jax_materials(), C_RX, C_TX, C_RXV, C_TXV,
                         3.0, jcfg)
    _fused_route(monkeypatch)
    with checks.recording_fused() as calls, torch.no_grad():
        ours = tt.trace_paths(tris, default_materials("cpu"), C_RX, C_TX,
                              C_RXV, C_TXV, 3.0,
                              dataclasses.replace(cfg, keep_rays=True))
    assert len(calls["bounce_pre"]) == len(calls["bounce_post"]) == 3
    _close_paths(ref, ours, rays=True)
    assert (np.abs(_np(ours.scatter.a_te)) > 0).sum() > 40
