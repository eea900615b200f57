"""PyTorch port vs JAX package: the whole forward trace and its material
gradients.

The port's ``trace_paths`` (plain torch nearest hit) is held against the JAX
``trace_paths(backend="jnp")`` on the same scene and material parameters
(moved across with ``convert.py``), on every ``ChannelInfo`` field and, with
``keep_rays=True``, on ``RaysInfo``.  Tolerance is that of
``tests/test_pallas.py::test_tracer_with_pallas_backend_matches_jnp``: more
than 99.5% of slots agree on being written, and written slots agree to rtol
1e-4 with an absolute floor of 1e-5 of the largest value (a decision that
flips at an f32 triangle edge changes a whole path).  Material gradients of
``sum |a_te|^2 + |a_tm|^2`` must match ``jax.grad`` to rtol 1e-4.  The
port's default, whose bounce and shadow queries take the rays' activity
mask, gives ``compact_rays=False``'s outputs and gradients bit for bit."""
import _torch_threads  # noqa: F401  (first: the thread share)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch.convert import materials_from_jax, soa_from_jax
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS

SCENES = {
    "reflector": (lambda: js.simple_reflector_scene(),
                  [[0.1, 0.0, 0.3], [-0.2, 0.1, 0.6], [0.3, -0.3, 0.2]],
                  [[0.0, 0.1, 0.5]]),
    "box": (lambda: js.box_scene(),
            [[0.5, 0.2, 1.0], [-1.0, 2.0, 0.5], [2.0, -1.0, 3.0]],
            [[0.0, 0.0, 1.5]]),
    "soup": (lambda: js.random_soup_scene(120, seed=5, extent=10.0,
                                          tri_size=2.0),
             [[4.0, 3.0, 1.0], [-6.0, 2.0, -1.0], [1.0, -7.0, 3.0]],
             [[0.5, 0.0, 0.0]]),
}


def _inputs(name, nrx):
    build, rx, tx = SCENES[name]
    soa = js.flatten_scene(build())
    rx = np.asarray(rx[:nrx], np.float32)
    tx = np.asarray(tx, np.float32)
    rxv = np.zeros_like(rx)
    rxv[0] = [1.0, 2.0, 0.0]
    txv = np.array([[0.5, -1.0, 0.25]], np.float32)
    return soa, rx, tx, rxv, txv


def _assert_slots_close(ref, ours, label, vec=False):
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ref.shape == ours.shape, f"{label}: {ref.shape} vs {ours.shape}"
    assert ref.dtype == ours.dtype, f"{label}: {ref.dtype} vs {ours.dtype}"
    w_ref = np.abs(ref) > 0
    w_our = np.abs(ours) > 0
    if vec:
        w_ref, w_our = w_ref.any(-1), w_our.any(-1)
    agree = (w_ref == w_our).mean()
    assert agree > 0.995, f"{label}: only {agree:.4f} of slots agree"
    m = w_ref & w_our
    if not m.any():
        return
    scale = np.abs(ref[m]).max()
    np.testing.assert_allclose(ours[m], ref[m], rtol=1e-4, atol=scale * 1e-5,
                               err_msg=label)


# every scene in both parities at nrx = 3 (the reference parity's clobber
# chain runs across RX); nrx = 1, whose code path is the same, on one scene
# per parity
TRACE_CASES = [(name, 3, parity) for parity in ("reference", "physical")
               for name in sorted(SCENES)] + [("soup", 1, "reference"),
                                              ("box", 1, "physical"),
                                              ("reflector", 1, "physical")]


@pytest.mark.parametrize("name,nrx,parity", TRACE_CASES)
def test_trace_matches_jax(name, nrx, parity):
    soa, rx, tx, rxv, txv = _inputs(name, nrx)
    P, B = 256, 3
    ref = jax_trace(soa, jax_materials(), rx, tx, rxv, txv, 3.0,
                    JaxConfig(num_paths=P, num_bounces=B, parity=parity,
                              backend="jnp", keep_rays=True))
    ours = trace_paths(soa_from_jax(vars(soa)),
                       materials_from_jax(vars(jax_materials())),
                       rx, tx, rxv, txv, 3.0,
                       TracerConfig(num_paths=P, num_bounces=B, parity=parity,
                                    backend="torch", keep_rays=True))
    for part in ("los", "scatter"):
        for f in ("a_te", "a_tm", "tau", "freq_shift"):
            _assert_slots_close(getattr(getattr(ref, part), f),
                                getattr(getattr(ours, part), f),
                                f"{part}.{f}")
        for f in ("directions_rx", "directions_tx"):
            _assert_slots_close(getattr(getattr(ref, part), f),
                                getattr(getattr(ours, part), f),
                                f"{part}.{f}", vec=True)
    np.testing.assert_array_equal(ours.los_blocked.numpy(),
                                  np.asarray(ref.los_blocked))
    assert ours.scatter.num_rays == B * P
    for part in ("rays_los", "rays_scatter"):
        r_ref, r_our = getattr(ref, part), getattr(ours, part)
        act_ref = np.asarray(r_ref.active)
        act_our = r_our.active.numpy()
        assert act_ref.shape == act_our.shape
        assert (act_ref == act_our).mean() > 0.995, part
        both = act_ref & act_our
        for f in ("origins", "directions"):
            a = np.asarray(getattr(r_ref, f))
            b = getattr(r_our, f).detach().numpy()
            assert a.shape == b.shape
            np.testing.assert_allclose(b[both], a[both], rtol=1e-4,
                                       atol=np.abs(a).max() * 1e-5,
                                       err_msg=f"{part}.{f}")


def _grad(mats, f):
    """Gradient of one material column; columns the tracer never reads
    (s2, s3, s3_alpha) get none, which is a zero gradient."""
    p = getattr(mats, f)
    return torch.zeros_like(p) if p.grad is None else p.grad


@pytest.mark.parametrize("name,parity", [("box", "reference"),
                                         ("reflector", "physical")])
def test_material_gradients_match_jax(name, parity):
    soa, rx, tx, rxv, txv = _inputs(name, 3)
    P, B = 256, 2

    def jax_loss(mats):
        res = jax_trace(soa, mats, rx, tx, rxv, txv, 3.0,
                        JaxConfig(num_paths=P, num_bounces=B, parity=parity,
                                  backend="jnp", keep_rays=False))
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
                + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)) * 1e6

    g_ref = jax.grad(jax.jit(jax_loss))(jax_materials())

    mats = materials_from_jax(vars(jax_materials()))
    res = trace_paths(soa_from_jax(vars(soa)), mats, rx, tx, rxv, txv, 3.0,
                      TracerConfig(num_paths=P, num_bounces=B, parity=parity,
                                   backend="torch", keep_rays=False))
    loss = (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e6
    loss.backward()
    assert np.abs(np.asarray(g_ref.a)).max() > 0
    for f in MATERIAL_FIELDS:
        g = _grad(mats, f)
        assert torch.isfinite(g).all(), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(g_ref, f)),
                                   rtol=1e-4, err_msg=f)


def test_grad_geometry_off_keeps_material_gradients():
    soa, rx, tx, rxv, txv = _inputs("box", 1)
    grads = []
    for gg in (True, False):
        mats = materials_from_jax(vars(jax_materials()))
        res = trace_paths(soa_from_jax(vars(soa)), mats, rx, tx, rxv, txv,
                          3.0, TracerConfig(num_paths=256, num_bounces=2,
                                            grad_geometry=gg,
                                            keep_rays=False))
        res.scatter.a_te.abs().square().sum().backward()
        grads.append(torch.stack([_grad(mats, f) for f in MATERIAL_FIELDS]))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=0.0)


def test_compact_rays_and_rx_groups_do_not_change_outputs():
    soa, rx, tx, rxv, txv = _inputs("box", 3)
    tris = soa_from_jax(vars(soa))
    mats = materials_from_jax(vars(jax_materials()))
    outs = []
    for kw in (dict(), dict(compact_rays=False), dict(rx_query_rays=256)):
        with torch.no_grad():
            res = trace_paths(tris, mats, rx, tx, rxv, txv, 3.0,
                              TracerConfig(num_paths=256, num_bounces=3,
                                           keep_rays=False, **kw))
        outs.append(res.scatter)
    for other in outs[1:]:
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
            assert torch.equal(getattr(outs[0], f), getattr(other, f)), f


@pytest.mark.parametrize("parity,kw", [
    ("reference", {}), ("physical", {}),
    ("physical", dict(transmission=True)),
    ("physical", dict(shade="fused", grad_positions=False,
                      grad_geometry=False))])
def test_default_mask_gives_the_unmasked_bits(parity, kw, monkeypatch):
    """The default (every bounce and shadow query given the rays' activity
    mask) against ``compact_rays=False``, through the walk on a scene that
    rays leave: outputs, LoS and material gradients bit-equal."""
    import hermespy_rt_tpu_torch.tracer as tracer_module
    assert TracerConfig().compact_rays
    soa, rx, tx, rxv, txv = _inputs("soup", 3)
    tris = soa_from_jax(vars(soa))
    dead = []
    real = tracer_module.walk_query

    def spy(*args, live=None, **kwargs):
        dead.append(live is not None and not bool(live.all()))
        return real(*args, live=live, **kwargs)

    monkeypatch.setattr(tracer_module, "walk_query", spy)
    out = []
    for off in ({}, dict(compact_rays=False)):
        mats = materials_from_jax(vars(jax_materials()))
        res = trace_paths(tris, mats, rx, tx, rxv, txv, 3.0,
                          TracerConfig(num_paths=128, num_bounces=3,
                                       parity=parity, walk=True,
                                       keep_rays=False, **kw, **off))
        res.scatter.a_te.abs().square().sum().backward()
        out.append((res, [_grad(mats, f) for f in MATERIAL_FIELDS]))
    assert any(dead)                 # the mask dropped rays somewhere
    (r0, g0), (r1, g1) = out
    for part in ("los", "scatter"):
        for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
            assert torch.equal(getattr(getattr(r0, part), f),
                               getattr(getattr(r1, part), f)), (part, f)
    assert any(bool(g.any()) for g in g0)
    for f, a, b in zip(MATERIAL_FIELDS, g0, g1):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
def test_backend_on_cpu_runs_the_twin_with_ray_chunk(backend, monkeypatch):
    """Every backend answers CPU rays with the plain twin at the config's
    ``ray_chunk``; the kernel's wrapper alone makes that device decision and
    launches nothing."""
    import hermespy_rt_tpu_torch.ops.intersect_cuda as ic
    import hermespy_rt_tpu_torch.tracer as tr
    chunks = []
    real = ic.intersect_torch

    def spy(*args, chunk_size, **kw):
        chunks.append(chunk_size)
        return real(*args, chunk_size=chunk_size, **kw)

    monkeypatch.setattr(ic, "intersect_torch", spy)
    monkeypatch.setattr(tr, "intersect_torch", spy)
    soa, rx, tx, rxv, txv = _inputs("box", 3)
    launches = ic.nearest_hit.launches
    with torch.no_grad():
        res = trace_paths(soa_from_jax(vars(soa)),
                          materials_from_jax(vars(jax_materials())), rx, tx,
                          rxv, txv, 3.0,
                          TracerConfig(num_paths=256, num_bounces=2,
                                       backend=backend, ray_chunk=100,
                                       keep_rays=False, compact_rays=True))
    assert ic.nearest_hit.launches == launches
    assert chunks == [100] * 5                # LoS + 2 x (bounce, shadow)
    with torch.no_grad():
        ref = trace_paths(soa_from_jax(vars(soa)),
                          materials_from_jax(vars(jax_materials())), rx, tx,
                          rxv, txv, 3.0,
                          TracerConfig(num_paths=256, num_bounces=2,
                                       keep_rays=False))
    for f in ("a_te", "a_tm", "tau", "freq_shift", "directions_rx"):
        assert torch.equal(getattr(res.scatter, f), getattr(ref.scatter, f)), f
