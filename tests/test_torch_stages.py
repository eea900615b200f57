"""PyTorch port vs JAX package: the full-gradient fused bounce path.

``shade="fused"`` with ``grad_positions`` (the JAX defaults) runs each stage
as an autograd node whose backward is the full per-stage kernel; with
``grad_positions=False, unroll_bounces=False`` as nodes whose backward is
the slim per-stage kernel.  Here the kernels' plain versions
(``ops/bounce_fused.py``: ``bounce_pre_bwd_plain`` and friends, then
``ops/fetch.py::scatter_add_plain`` for the table) are held against the
JAX package's per-stage backwards (``_bounce_pre_bwd_vjp``,
``_bounce_post_bwd``, Pallas in interpret mode) on the operands of a port
trace and random cotangents; the scatter-add against
``pallas_scatter_add``; the whole path's gradients (materials, RX and TX
positions, carrier frequency, vertices) against ``jax.grad`` of JAX
``trace_paths(shade="xla", backend="jnp")``; and the per-stage slim path
against the whole-loop ``FusedLoopSlim``.  Tolerance: 3e-5 of each row's or
leaf's largest magnitude plus 1e-16 (``tests/test_bounce_fused.py:43-56``,
``:125``), a complex value's (re, im) rows and a vector's components taken
together."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.ops import bounce_fused as jfused
from hermespy_rt_tpu.ops.fetch_pallas import pallas_scatter_add
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.convert import materials_from_jax, soa_from_jax
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.ops.bounce_fused import (
    NORMAL_COL, TABLE_COLS, FusedSpec, bounce_post_bwd_plain,
    bounce_post_bwd_slim_plain, bounce_pre_bwd_plain,
    bounce_pre_bwd_slim_plain)
from hermespy_rt_tpu_torch.ops.fetch import scatter_add_plain

AMP, VEC = checks.AMP_GROUPS, checks.VEC_GROUPS
FREQ = 3.0
TOL = dict(rtol=checks.LEAF_RTOL, atol=checks.LEAF_ATOL)

# a dense soup around the TX, so rays hit, die, cross their own plane and
# are occluded (tests/test_torch_fused.py's stage operands)
SOUP = dict(build=lambda m: m.random_soup_scene(120, seed=5, extent=10.0,
                                                tri_size=2.0),
            rx=[[4.0, 3.0, 1.0], [-6.0, 2.0, -1.0]], tx=[[0.5, 0.0, 0.0]])


def _np(x):
    return x.detach().numpy()


def _scene(build, seed=3):
    """The flattened JAX scene with a velocity per triangle drawn from a
    seed, so that the Doppler chains (and the ``k_dop`` cotangents) carry
    values."""
    soa = js.flatten_scene(build(js))
    vel = np.random.default_rng(seed).uniform(-2.0, 2.0, soa.velocity.shape)
    return dataclasses.replace(soa, velocity=jnp.asarray(vel, jnp.float32))


def _close(ours, ref, label, groups=None):
    """Rows (or row groups) within 3e-5 of their largest magnitude plus
    1e-16, the last axis the one compared along.  The floor is for rows
    that are zero but for rounding: the scattering normalisation cancels
    the directivity ``s exp(-s1_alpha |theta_s - theta_i|)``, so the
    incidence angle's and ``s``'s cotangents are noise ~1e-23 on both
    sides."""
    checks.rows_close(torch.as_tensor(np.asarray(ours)),
                      torch.as_tensor(np.array(ref)), checks.ROW_RTOL, label,
                      groups, atol=checks.LEAF_ATOL)


def _leaf_close(ours, ref, label):
    a, b = np.asarray(ref, np.float64), np.asarray(ours, np.float64)
    tol = TOL["rtol"] * max(np.abs(a).max(), 1e-30) + TOL["atol"]
    err = np.abs(a - b).max()
    assert err <= tol, f"{label}: {err} > {tol}"


def _stage_calls(parity, nrx, **kw):
    """The recorded fused calls of one port trace with its backward."""
    soa = _scene(SOUP["build"])
    mats = materials_from_jax(vars(jax_materials()))
    cfg = TracerConfig(**{**dict(num_paths=512, num_bounces=2, shade="fused",
                                 keep_rays=False, compact_rays=True,
                                 parity=parity), **kw})
    rx = np.asarray(SOUP["rx"][:nrx], np.float32)
    tx = np.asarray(SOUP["tx"], np.float32)
    with checks.recording_fused() as calls:
        res = trace_paths(soa_from_jax(vars(soa)), mats, rx, tx,
                          np.zeros_like(rx), np.zeros_like(tx), FREQ, cfg)
        checks.grad_loss(res).backward()
    return calls


def _jax_spec(spec, R):
    return jfused.FusedSpec(nrx=spec.nrx, parity=spec.parity,
                            grad_geometry=spec.grad_geometry,
                            grad_positions=spec.grad_positions,
                            eps_o=spec.eps_o, interpret=True,
                            block=-(-R // 128) * 128)


def _j(x):
    return jnp.asarray(_np(x))


def _od(o, d):
    return jfused.od_rows_from_vectors(_j(o), _j(d))


def _sh(sh_d, sh_o):
    """The JAX stages' [nrx * 8, R] shadow rows (ds, origin, zeros)."""
    nrx, R = sh_d.shape[:2]
    return jnp.asarray(np.concatenate(
        [_np(sh_d).transpose(0, 2, 1), _np(sh_o).transpose(0, 2, 1),
         np.zeros((nrx, 2, R), np.float32)], axis=1).reshape(nrx * 8, R))


def _table(T, rows, idx, cols, extra=None):
    """The port's table cotangent: payload rows summed at ``idx`` into the
    last ``cols`` columns (plus the occluder-normal rows ``extra``)."""
    d_tab = torch.zeros((T, TABLE_COLS))
    d_tab[:, TABLE_COLS - cols:] += scatter_add_plain(idx, rows, T)
    if extra is not None:
        occ, d_n_o = extra
        d_tab[:, NORMAL_COL:NORMAL_COL + 3] += scatter_add_plain(
            occ.reshape(-1), d_n_o.reshape(-1, 3), T)
    return d_tab


def _cot(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("parity,nrx,grad_geometry,grad_positions", [
    ("reference", 1, True, True), ("reference", 2, False, True),
    ("physical", 1, False, True), ("physical", 2, True, True),
    ("reference", 2, False, False), ("physical", 1, False, False)])
def test_stage_backwards_match_jax(parity, nrx, grad_geometry,
                                   grad_positions):
    calls = _stage_calls(parity, nrx, grad_geometry=grad_geometry,
                         grad_positions=grad_positions,
                         unroll_bounces=False)
    (args, pre), = calls["bounce_pre"][1:]       # the second bounce
    spec, o, d, st, act, idx, table, material, rx_pos, sc = args
    assert (spec.grad_geometry, spec.grad_positions) == (grad_geometry,
                                                         grad_positions)
    R, T = o.shape[0], table.shape[0]
    jspec = _jax_spec(spec, R)
    fslm, k_dop = (jnp.float32(v) for v in _np(sc))
    rng = np.random.default_rng(7)
    live = pre.live
    # random cotangents; those of the dead rays' ex / shadow rows are 0, as
    # in a trace (the post stage writes nothing for a dead ray): the port
    # drops a dead ray's payload row, JAX adds it to row 0
    g = dict(o2=_cot(rng, R, 3), d2=_cot(rng, R, 3), st2=_cot(rng, 6, R),
             ex=_cot(rng, 3, R) * live, sh_d=_cot(rng, nrx, R, 3)
             * live[None, :, None], d2rx=_cot(rng, nrx, R) * live)
    res_pre = jnp.asarray(_np(pre.res))
    (j_od, j_st, _, _, j_tab, j_rxp, j_fslm, j_kdop) = \
        jfused._bounce_pre_bwd_vjp(
            jspec, (_od(o, d), _j(st), _j(act), _j(idx), _j(table),
                    _j(rx_pos), res_pre, fslm, k_dop),
            (_od(g["o2"], g["d2"]), _j(g["st2"]), _j(g["ex"]),
             _sh(g["sh_d"], torch.zeros_like(g["sh_d"])), _j(g["d2rx"])))
    if grad_positions:
        d_o, d_d, d_st, d_pay, d_rxp, d_sc = bounce_pre_bwd_plain(
            spec, o, d, st, act, idx, table, rx_pos, sc, g["o2"], g["d2"],
            g["st2"], g["ex"], g["sh_d"], g["d2rx"])
        _close(_np(d_d).T, np.asarray(j_od)[0:3], "pre.d_d", VEC)
        _close(_np(d_o).T, np.asarray(j_od)[3:6], "pre.d_o", VEC)
        _leaf_close(_np(d_rxp), j_rxp, "pre.d_rxp")
        _leaf_close(_np(d_sc), [j_fslm, j_kdop], "pre.d_sc")
    else:
        d_st, d_pay = bounce_pre_bwd_slim_plain(spec, st, act, idx, table,
                                                pre.res, g["st2"])
    _close(_np(d_st), j_st, "pre.d_st", AMP)
    _close(_np(_table(T, d_pay, pre.excl, d_pay.shape[1])).T,
           np.asarray(j_tab).T, "pre.d_table")

    (args, post), = calls["bounce_post"][1:]
    (spec, d2, st2, ex, sh_d, d2rx, t_self, crossing, excl, live_, t_o,
     idx_o, table, sc) = args
    d_out = _cot(rng, nrx, 6, R)
    outs = jfused._bounce_post_bwd(
        jspec, (_od(pre.o2, d2), _j(st2), _j(ex), _sh(sh_d, pre.sh_o),
                _j(d2rx), _j(t_self), jnp.asarray(_np(crossing).astype(
                    np.int32)), jnp.asarray(_np(excl)[None]),
                jnp.asarray(_np(live_).astype(np.int32)[None]), _j(t_o),
                _j(idx_o), _j(table), fslm, k_dop,
                jnp.asarray(_np(post.res).reshape(nrx * 6, R))),
        (jnp.asarray(_np(d_out).reshape(nrx * 6, R)), None))
    j_tab = np.asarray(outs[11])
    if grad_positions:
        (d_d2, d_st2, d_ex, d_sh_d, d_d2rx, d_pay, d_n_o, occ,
         d_sc) = bounce_post_bwd_plain(spec, d2, st2, ex, sh_d, d2rx, t_self,
                                       crossing, excl, live_, t_o, idx_o,
                                       table, sc, d_out)
        assert (d_n_o is not None) == (grad_geometry
                                       and parity == "reference")
        j_sh = np.asarray(outs[3]).reshape(nrx, 8, R)
        _close(_np(d_d2).T, np.asarray(outs[0])[0:3], "post.d_d2", VEC)
        _close(_np(d_ex), outs[2], "post.d_ex")
        _close(_np(d_sh_d).transpose(0, 2, 1), j_sh[:, 0:3], "post.d_sh_d",
               VEC)
        _close(_np(d_d2rx), outs[4], "post.d_d2rx")
        _leaf_close(_np(d_sc), [outs[12], outs[13]], "post.d_sc")
        extra = None if d_n_o is None else (occ, d_n_o)
    else:
        d_st2, d_pay = bounce_post_bwd_slim_plain(spec, st2, excl, table,
                                                  post.res, d_out)
        extra = None
    _close(_np(d_st2), outs[1], "post.d_st2", AMP)
    _close(_np(_table(T, d_pay, excl, d_pay.shape[1], extra)).T, j_tab.T,
           "post.d_table")


@pytest.mark.parametrize("C", [27, 12, 2, 3])
def test_scatter_add_matches_pallas(C):
    rng = np.random.default_rng(C)
    T, N = 97, 3000
    idx = rng.integers(-3, T, N).astype(np.int32)     # negatives dropped
    idx[:700] = 5                                      # a long run
    g = rng.normal(size=(N, C)).astype(np.float32)
    ours = scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(g), T)
    ref = pallas_scatter_add(jnp.asarray(idx), jnp.asarray(g), T,
                             interpret=True)
    _close(_np(ours).T, np.asarray(ref).T, "scatter_add")


E2E = {
    "soup": (lambda m: m.random_soup_scene(234),
             [[10.0, 5.0, 2.0], [11.5, 3.0, 2.25]], [[-20.0, -10.0, 10.0]]),
    "box": (lambda m: m.box_scene(),
            [[0.5, 0.2, 1.0], [-1.0, 2.0, 0.5]], [[0.0, 0.0, 1.5]]),
}


@pytest.mark.parametrize("name,parity,grad_geometry", [
    ("soup", "reference", True), ("soup", "physical", False),
    ("box", "reference", False), ("box", "physical", True)])
def test_full_gradient_trace_matches_jax(name, parity, grad_geometry):
    build, rx, tx = E2E[name]
    soa = _scene(build)
    rx = np.asarray(rx, np.float32)
    tx = np.asarray(tx, np.float32)
    # no TX velocity: its launch Doppler summed over the Fibonacci sphere
    # cancels to ~1e-4 of its terms, which would leave the frequency's
    # gradient to the two frameworks' summation orders; the triangles move
    rxv, txv = np.zeros_like(rx), np.zeros_like(tx)
    jcfg = JaxConfig(num_paths=512, num_bounces=2, parity=parity,
                     backend="jnp", keep_rays=False, compact_rays=True,
                     grad_geometry=grad_geometry)

    def jax_loss(m, rx_, tx_, f, v0):
        r = jax_trace(dataclasses.replace(soa, v0=v0), m, rx_, tx_, rxv,
                      txv, f, jcfg)
        return ((jnp.sum(jnp.abs(r.scatter.a_te) ** 2)
                 + jnp.sum(jnp.abs(r.scatter.a_tm) ** 2)) * 1e9
                + jnp.sum(r.scatter.tau) * 1e3
                + jnp.sum(r.scatter.freq_shift) * 1e-3)

    g_m, g_rx, g_tx, g_f, g_v0 = jax.jit(jax.grad(
        jax_loss, argnums=(0, 1, 2, 3, 4)))(
        jax_materials(), jnp.asarray(rx), jnp.asarray(tx), jnp.float32(FREQ),
        soa.v0)

    mats = materials_from_jax(vars(jax_materials()))
    tris = soa_from_jax(vars(soa))
    v0 = tris.v0.clone().requires_grad_()
    leaves = dict(rx=torch.tensor(rx, requires_grad=True),
                  tx=torch.tensor(tx, requires_grad=True),
                  f=torch.tensor(FREQ, requires_grad=True), v0=v0)
    cfg = TracerConfig(num_paths=512, num_bounces=2, parity=parity,
                       shade="fused", keep_rays=False, compact_rays=True,
                       grad_geometry=grad_geometry)
    with checks.recording_fused() as calls:
        res = trace_paths(dataclasses.replace(tris, v0=v0), mats,
                          leaves["rx"], leaves["tx"], rxv, txv, leaves["f"],
                          cfg)
        checks.grad_loss(res).backward()
    assert [len(calls[n]) for n in ("bounce_pre", "bounce_post",
                                    "bounce_pre_bwd", "bounce_post_bwd",
                                    "loop_bwd_slim")] == [2, 2, 2, 2, 0]
    checks.leaves_close(checks.grads_of(mats),
                        {f: torch.tensor(np.asarray(getattr(g_m, f)))
                         for f in MATERIAL_FIELDS}, TOL["rtol"], TOL["atol"],
                        "material gradients")
    for key, ref in (("rx", g_rx), ("tx", g_tx), ("f", g_f), ("v0", g_v0)):
        ours = leaves[key].grad
        ours = np.zeros(np.shape(ref)) if ours is None else _np(ours)
        _leaf_close(ours, ref, f"{key} gradient")
    assert float(np.abs(np.asarray(g_rx)).max()) > 0
    assert (float(np.abs(np.asarray(g_v0)).max()) > 0) == grad_geometry


@pytest.mark.parametrize("parity,nrx", [("reference", 2), ("physical", 1)])
def test_slim_stages_equal_whole_loop(parity, nrx):
    """``unroll_bounces=False`` (slim per-stage backwards, then the
    scatter-add per triangle) gives the material gradients of the
    whole-loop node (its sum per material)."""
    grads = {}
    for unroll in (True, False):
        calls_key = "loop_bwd_slim" if unroll else "bounce_pre_bwd_slim"
        soa = _scene(SOUP["build"])
        mats = materials_from_jax(vars(jax_materials()))
        cfg = TracerConfig(num_paths=512, num_bounces=2, shade="fused",
                           grad_positions=False, grad_geometry=False,
                           unroll_bounces=unroll, keep_rays=False,
                           compact_rays=True, parity=parity)
        rx = np.asarray(SOUP["rx"][:nrx], np.float32)
        with checks.recording_fused() as calls:
            res = trace_paths(soa_from_jax(vars(soa)), mats, rx,
                              np.asarray(SOUP["tx"], np.float32),
                              np.zeros_like(rx), np.zeros((1, 3)), FREQ, cfg)
            checks.grad_loss(res).backward()
        assert len(calls[calls_key]) == (1 if unroll else 2)
        grads[unroll] = checks.grads_of(mats)
    checks.leaves_close(grads[False], grads[True], TOL["rtol"], TOL["atol"],
                        "slim stages vs whole loop")
    assert any(float(v.abs().max()) > 0 for v in grads[False].values())


def test_fused_spec_pairs_grad_flags():
    with pytest.raises(ValueError, match="grad_geometry=False"):
        FusedSpec(nrx=1, grad_positions=False, grad_geometry=True)
    spec = FusedSpec(nrx=2)
    assert spec.grad_positions and spec.grad_geometry
