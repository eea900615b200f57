"""PyTorch port vs JAX package: the fused bounce path (``shade="fused"``).

Per stage, the port's plain versions (``ops/bounce_fused.py``, what the CUDA
kernels compute) are held against the JAX package's fused stages, the Pallas
kernels run in interpret mode, on the operands of a small procedural trace:
decisions equal, values within 3e-5 of their row's largest magnitude (the
tier of ``tests/test_bounce_fused.py``, a complex value's (re, im) rows and
a vector's components taken together, since their small parts come from
cancellation of the large ones).  The whole-loop backward is held against
JAX's ``_fused_loop_bwd_slim`` on the same residuals; the whole path, with
its material gradients, against JAX ``trace_paths(shade="xla")``.  Material
gradients are compared in the material parameters (a table cotangent goes
through ``precompute_eta``), at 3e-5 of each leaf's largest magnitude plus
1e-16 (``tests/test_bounce_fused.py:125``).  Then the port's own contracts:
int32 material ids past 256, the config's refusals, no residuals without
gradient, no launches for CPU tensors."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.ops import bounce_fused as jfused
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch import tracer as tracer_module
from hermespy_rt_tpu_torch.convert import materials_from_jax, soa_from_jax
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops
from hermespy_rt_tpu_torch.ops.bounce_fused import loop_bwd_slim_plain

AMP, VEC = checks.AMP_GROUPS, checks.VEC_GROUPS
FUSED = checks.FUSED
FREQ = 3.0


def _rows_close(ours, ref, label, groups=None):
    """The kernels' tier: within 3e-5 of the row's (or row group's) largest
    magnitude, rays on the last axis."""
    checks.rows_close(torch.as_tensor(np.asarray(ours)),
                      torch.as_tensor(np.array(ref)), checks.ROW_RTOL, label,
                      groups)


def _leaves_close(ours, ref, label):
    """Each material leaf within 3e-5 of its largest magnitude plus 1e-16."""
    checks.leaves_close(ours, ref, checks.LEAF_RTOL, checks.LEAF_ATOL, label)


def _param_grads(mats, d_eta_tab):
    return checks.material_grads(mats, torch.tensor(np.asarray(d_eta_tab)),
                                 FREQ)


def _fused_cfg(**kw):
    base = dict(num_paths=512, num_bounces=2, shade="fused",
                grad_positions=False, grad_geometry=False, keep_rays=False,
                compact_rays=True)
    return TracerConfig(**{**base, **kw})


def _loss(res):
    return (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e9


# the per-stage operands: a dense soup around the TX, so rays hit, die,
# cross their own plane and are occluded
SOUP = dict(build=lambda m: m.random_soup_scene(120, seed=5, extent=10.0,
                                                tri_size=2.0),
            rx=[[4.0, 3.0, 1.0], [-6.0, 2.0, -1.0]], tx=[[0.5, 0.0, 0.0]])


def _stage_calls(parity, nrx):
    soa = js.flatten_scene(SOUP["build"](js))
    mats = materials_from_jax(vars(jax_materials()))
    rx = np.asarray(SOUP["rx"][:nrx], np.float32)
    tx = np.asarray(SOUP["tx"], np.float32)
    with checks.recording_fused() as calls:
        res = trace_paths(soa_from_jax(vars(soa)), mats, rx, tx,
                          np.zeros_like(rx), np.zeros_like(tx), FREQ,
                          _fused_cfg(parity=parity))
        _loss(res).backward()
    return calls, mats


def _jax_spec(spec, R):
    return jfused.FusedSpec(nrx=spec.nrx, parity=spec.parity,
                            grad_geometry=False, grad_positions=False,
                            eps_o=spec.eps_o, interpret=True,
                            block=-(-R // 128) * 128)


def _np(x):
    return x.detach().numpy()


def _od(o, d):
    """The JAX kernels' [8, R] ray rows (d, o, zeros) from [R, 3] o, d."""
    return jfused.od_rows_from_vectors(jnp.asarray(_np(o)), jnp.asarray(_np(d)))


@pytest.mark.parametrize("nrx", [1, 2])
@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_stages_match_jax(parity, nrx):
    calls, _ = _stage_calls(parity, nrx)
    (args, ours), = calls["bounce_pre"][1:]       # the second bounce
    spec, o, d, st, act, idx, table, material, rx_pos, sc = args
    R = o.shape[0]
    jspec = _jax_spec(spec, R)
    fslm, k_dop = (jnp.float32(v) for v in _np(sc))
    (od2, st2, ex, sh, d2rx, t_self, crossing, excl, live), res = \
        jfused._bounce_pre_fwd(jspec, _od(o, d), jnp.asarray(_np(st)),
                               jnp.asarray(_np(act)), jnp.asarray(_np(idx)),
                               jnp.asarray(_np(table)), jnp.asarray(_np(rx_pos)),
                               fslm, k_dop,
                               material=jnp.asarray(_np(material)))
    sh = np.asarray(sh).reshape(nrx, 8, R)
    np.testing.assert_array_equal(_np(ours.crossing), np.asarray(crossing) != 0)
    np.testing.assert_array_equal(_np(ours.excl), np.asarray(excl)[0])
    np.testing.assert_array_equal(_np(ours.live), np.asarray(live)[0] != 0)
    np.testing.assert_array_equal(_np(ours.mat), np.asarray(res[-1])[0])
    od2 = np.asarray(od2)
    for label, a, b, g in (
            ("d2", _np(ours.d2).T, od2[0:3], VEC),
            ("o2", _np(ours.o2).T, od2[3:6], VEC),
            ("st2", _np(ours.st2), st2, AMP), ("ex", _np(ours.ex), ex, None),
            ("sh_d", _np(ours.sh_d).transpose(0, 2, 1), sh[:, 0:3], VEC),
            ("sh_o", _np(ours.sh_o).transpose(0, 2, 1), sh[:, 3:6], VEC),
            ("d2rx", _np(ours.d2rx), d2rx, None),
            ("t_self", _np(ours.t_self), t_self, None),
            ("res", _np(ours.res), res[-2], None)):
        _rows_close(a, b, f"pre.{label}", g)

    (args, ours), = calls["bounce_post"][1:]
    (spec, d2_, st2_, ex_, sh_d_, d2rx_, t_self_, crossing_, excl_, live_,
     t_o, idx_o, table, sc) = args
    pre = calls["bounce_pre"][1][1]
    sh_j = np.concatenate([_np(pre.sh_d).transpose(0, 2, 1),
                           _np(pre.sh_o).transpose(0, 2, 1),
                           np.zeros((nrx, 2, R), np.float32)], axis=1)
    (out, write), res = jfused._bounce_post_fwd(
        jspec, _od(pre.o2, d2_), jnp.asarray(_np(st2_)),
        jnp.asarray(_np(ex_)), jnp.asarray(sh_j.reshape(nrx * 8, R)),
        jnp.asarray(_np(d2rx_)), jnp.asarray(_np(t_self_)),
        jnp.asarray(_np(crossing_).astype(np.int32)),
        jnp.asarray(_np(excl_)[None]),
        jnp.asarray(_np(live_).astype(np.int32)[None]),
        jnp.asarray(_np(t_o)), jnp.asarray(_np(idx_o)),
        jnp.asarray(_np(table)), fslm, k_dop)
    np.testing.assert_array_equal(_np(ours.write), np.asarray(write) != 0)
    assert _np(ours.write).any()
    _rows_close(_np(ours.out), np.asarray(out).reshape(nrx, 6, R),
                "post.out", AMP)
    _rows_close(_np(ours.res), np.asarray(res[-1]).reshape(nrx, 6, R),
                "post.res")


@pytest.mark.parametrize("nrx", [1, 2])
@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_loop_backward_matches_jax(parity, nrx):
    calls, mats = _stage_calls(parity, nrx)
    (args, (d_st0, d_tab)), = calls["loop_bwd_slim"]
    spec, eta_tab, st_all, live_all, mat_all, res_pre, res_post, d_out = args
    B, R = live_all.shape
    j_st0, j_tab = jfused._fused_loop_bwd_slim(
        _jax_spec(spec, R), B, jnp.asarray(_np(eta_tab)),
        jnp.asarray(_np(st_all)),
        jnp.asarray(_np(live_all).astype(np.int32)[:, None]),
        jnp.asarray(_np(mat_all)[:, None]), jnp.asarray(_np(res_pre)),
        jnp.asarray(_np(res_post).reshape(B, 6 * nrx, R)),
        jnp.asarray(_np(d_out).reshape(B, 6 * nrx, R)))
    _rows_close(_np(d_st0), j_st0, "d_st0", AMP)
    _leaves_close(_param_grads(mats, _np(d_tab)), _param_grads(mats, j_tab),
                  "material gradients")


E2E = {
    "soup": (lambda m: m.random_soup_scene(234),
             [[10.0, 5.0, 2.0], [11.5, 3.0, 2.25]], [[-20.0, -10.0, 10.0]]),
    "box": (lambda m: m.box_scene(),
            [[0.5, 0.2, 1.0], [-1.0, 2.0, 0.5]], [[0.0, 0.0, 1.5]]),
}


@pytest.mark.parametrize("name,parity,nrx", [
    ("soup", "reference", 1), ("soup", "physical", 2),
    ("box", "reference", 2), ("box", "physical", 1)])
def test_fused_trace_matches_jax(name, parity, nrx):
    build, rx, tx = E2E[name]
    soa = js.flatten_scene(build(js))
    rx = np.asarray(rx[:nrx], np.float32)
    tx = np.asarray(tx, np.float32)
    rxv, txv = np.zeros_like(rx), np.array([[0.5, -1.0, 0.25]], np.float32)
    jcfg = JaxConfig(num_paths=512, num_bounces=2, parity=parity,
                     backend="jnp", keep_rays=False, compact_rays=True,
                     grad_geometry=False)

    def jax_loss(m):
        res = jax_trace(soa, m, rx, tx, rxv, txv, FREQ, jcfg)
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
                + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)) * 1e9, res

    (_, ref), g_ref = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax_materials())
    mats = materials_from_jax(vars(jax_materials()))
    ours = trace_paths(soa_from_jax(vars(soa)), mats, rx, tx, rxv, txv, FREQ,
                       _fused_cfg(parity=parity))
    _loss(ours).backward()
    for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
        a, b = np.asarray(getattr(ref.scatter, f)), _np(getattr(ours.scatter,
                                                               f))
        w_a, w_b = np.abs(a) > 0, np.abs(b) > 0
        if f == "directions_rx":
            w_a, w_b = w_a.any(-1), w_b.any(-1)
        assert (w_a == w_b).mean() > 0.995, f
        m = w_a & w_b
        if m.any():
            np.testing.assert_allclose(b[m], a[m], rtol=1e-4,
                                       atol=np.abs(a[m]).max() * 1e-5,
                                       err_msg=f)
    assert (np.abs(_np(ours.scatter.a_te)) > 0).any()
    _leaves_close(checks.grads_of(mats),
                  {f: torch.tensor(np.asarray(getattr(g_ref, f)))
                   for f in MATERIAL_FIELDS}, "material gradients")


def test_300_materials_fused_equals_op_path():
    """Triangle material ids past 256 (the JAX pre kernel's bf16 ids are
    exact only below 256): the fused path's gradients equal the op path's."""
    soa = js.flatten_scene(SOUP["build"](js))
    rng = np.random.default_rng(3)
    arrays = dict(vars(soa))
    arrays["material"] = rng.integers(250, 300, soa.v0.shape[0])
    base = vars(jax_materials())
    cols = {f: np.resize(np.asarray(base[f]), 300) for f in MATERIAL_FIELDS}
    cols["s"] = rng.uniform(0.1, 0.6, 300).astype(np.float32)
    cols["s1_alpha"] = rng.uniform(1.0, 4.0, 300).astype(np.float32)
    rx = np.asarray(SOUP["rx"], np.float32)
    tx = np.asarray(SOUP["tx"], np.float32)
    grads, outs = {}, {}
    for shade in ("xla", "fused"):
        mats = materials_from_jax(cols)
        assert mats.num_materials == 300
        cfg = (_fused_cfg(parity="physical") if shade == "fused" else
               dataclasses.replace(_fused_cfg(parity="physical"),
                                   shade="xla"))
        res = trace_paths(soa_from_jax(arrays), mats, rx, tx,
                          np.zeros_like(rx), np.zeros_like(tx), FREQ, cfg)
        _loss(res).backward()
        grads[shade], outs[shade] = checks.grads_of(mats), res.scatter
    assert float(grads["xla"]["a"][256:].abs().max()) > 0
    _leaves_close(grads["fused"], grads["xla"], "300 materials")
    for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
        assert torch.equal(getattr(outs["fused"], f), getattr(outs["xla"], f))


@pytest.mark.parametrize("kw,match", [
    (dict(shade="fused", unroll_bounces="no"), "unroll_bounces must be"),
    (dict(grad_positions=False, grad_geometry=True), "grad_geometry=False"),
    (dict(cull="yes"), "cull must be"),
    (dict(shade="bogus"), "shade must be"),
])
def test_config_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        TracerConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(shade="fused"), dict(shade="fused", grad_geometry=False),
    dict(shade="fused", grad_positions=False, grad_geometry=False,
         unroll_bounces=False)])
def test_config_accepts_fused_gradients(kw):
    """The JAX defaults (grad_positions, grad_geometry) run the fused path
    with its full per-stage backward; unroll_bounces=False the slim
    per-stage one."""
    cfg = TracerConfig(**kw)
    assert cfg.shade == "fused" and isinstance(cfg.unroll_bounces, bool)


def test_no_grad_keeps_no_residuals(monkeypatch):
    saved = []
    real = tracer_module._fused_forward

    def spy(*args, save, **kw):
        primal, resid = real(*args, save=save, **kw)
        saved.append(resid)
        return primal, resid

    monkeypatch.setattr(tracer_module, "_fused_forward", spy)
    soa = soa_from_jax(vars(js.flatten_scene(js.box_scene())))
    mats = materials_from_jax(vars(jax_materials()))
    args = (soa, mats, [[0.5, 0.2, 1.0]], [[0.0, 0.0, 1.5]], [[0.0] * 3],
            [[0.0] * 3], FREQ, _fused_cfg(num_paths=64))
    with torch.no_grad():
        res = trace_paths(*args)
    assert saved == [None] and not res.scatter.a_te.requires_grad
    res = trace_paths(*args)
    assert saved[-1] is not None and res.scatter.a_te.requires_grad


def test_cpu_wrappers_run_plain_and_count_no_launch():
    kernels = {n: getattr(fused_ops, n) for n in FUSED}
    counts = {n: k.launches for n, k in kernels.items()}
    calls, _ = _stage_calls("reference", 1)
    assert [len(calls[n]) for n in FUSED] == [2, 2, 1]
    assert {n: k.launches for n, k in kernels.items()} == counts
    (args, out), = calls["loop_bwd_slim"]
    assert all(torch.equal(a, b)
               for a, b in zip(out, loop_bwd_slim_plain(*args)))
