"""Gradients of the PyTorch port against central finite differences of its
own forward pass, and its velocity gradients against ``jax.grad``.

``tests/test_grad.py``'s finite-difference checks on the procedural
reflector run on the port (op path, plain nearest hit, CPU) at their
tolerances: material permittivity, conductivity, roughness and lobe width
(5%), the TX position (5%), TX and RX velocities (2%), the mesh velocity
(2%) and the carrier frequency (5%); and the material check again under
``transmission=True``, with a plate between TX and RX whose penetration
loss carries the gradient.  Then RX, TX and triangle velocities are
differentiated against ``jax.grad`` on the same inputs with a seeded
weighting of the Doppler outputs (so that the TX term does not cancel over
the launch sphere), within rtol 1e-4 of each leaf's largest magnitude."""
import _torch_threads  # noqa: F401  (first: the thread share)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.scene import flatten_scene as jax_flatten
from hermespy_rt_tpu.scene import simple_reflector_scene as jax_reflector
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.config import TracerConfig
from hermespy_rt_tpu_torch.convert import soa_from_jax
from hermespy_rt_tpu_torch.materials import default_materials
from hermespy_rt_tpu_torch.scene import (HostMesh, HostScene, flatten_scene,
                                         simple_reflector_scene)
from hermespy_rt_tpu_torch.tracer import trace_paths

CFG = TracerConfig(num_paths=256, num_bounces=2, backend="torch",
                   keep_rays=False)
RX = np.array([[0.1, -0.05, 0.4]], np.float32)
TX = np.array([[0.0, 0.1, 0.6]], np.float32)
Z = np.zeros((1, 3), np.float32)
C = 299792458.0


@pytest.fixture(scope="module")
def reflector():
    return flatten_scene(simple_reflector_scene(), device="cpu")


def _mats(field=None, delta=0.0, row=1):
    """The default table with ``field[row]`` moved by ``delta``."""
    mats = default_materials("cpu")
    if field is not None:
        with torch.no_grad():
            getattr(mats, field)[row] += delta
    return mats


def _power(res):
    return (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e6


def _fd(loss, x0, eps):
    """Central difference of the scalar ``loss(x)`` at ``x0`` along every
    component of the numpy array ``x0``."""
    out = np.zeros(x0.shape, np.float64)
    for i in np.ndindex(x0.shape):
        hi, lo = x0.copy(), x0.copy()
        hi[i] += eps
        lo[i] -= eps
        out[i] = (float(loss(hi)) - float(loss(lo))) / (2 * eps)
    return out


def _assert_fd(g, fd, rtol, floor, label):
    scale = np.maximum(np.maximum(np.abs(fd), np.abs(g)), floor)
    assert np.all(np.isfinite(g)), label
    assert np.all(np.abs(g - fd) / scale < rtol), (
        f"{label}: grad {g} vs fd {fd}")


def _material_fd(tris, cfg, loss_of, fields, label, row=1):
    mats = _mats()
    loss_of(trace_paths(tris, mats, RX, TX, Z, Z, 3.0, cfg)).backward()
    for field, eps in fields:
        g = float(getattr(mats, field).grad[row])
        with torch.no_grad():
            f_hi = loss_of(trace_paths(tris, _mats(field, eps, row), RX, TX,
                                       Z, Z, 3.0, cfg))
            f_lo = loss_of(trace_paths(tris, _mats(field, -eps, row), RX, TX,
                                       Z, Z, 3.0, cfg))
        fd = (float(f_hi) - float(f_lo)) / (2 * eps)
        assert g != 0.0, f"{label} material.{field}"
        _assert_fd(np.array(g), np.array(fd), 0.05, 1e-8,
                   f"{label} material.{field}")


def test_material_grads_vs_fd(reflector):
    _material_fd(reflector, CFG, _power,
                 [("a", 0.05), ("c", 0.005), ("s", 0.01), ("s1_alpha", 0.05),
                  ("d", 0.01)], "reflector")


def test_transmission_material_grads_vs_fd():
    """A wood plate at z = 0.5 between TX (z = 0.6) and RX (z = 0.4), above
    the reflector: the LoS passes through it, and the shadow rays of its
    own reflections cross it, so its permittivity and conductivity reach
    the loss through the transmission coefficients."""
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    plate = np.array([[-2, -2, 0.5], [2, -2, 0.5], [2, 2, 0.5],
                      [-2, 2, 0.5]], np.float32)
    host = simple_reflector_scene()
    host = HostScene(host.meshes + [HostMesh(plate, quad, material_index=4)])
    tris = flatten_scene(host, device="cpu")
    cfg = dataclasses.replace(CFG, parity="physical", transmission=True)

    def loss_of(res):
        return _power(res) + res.los.a_te.abs().square().sum() * 1e2

    res = trace_paths(tris, _mats(), RX, TX, Z, Z, 3.0, cfg)
    assert bool(res.los_blocked.all())
    assert float(res.los.a_te.detach().abs().max()) > 0
    _material_fd(tris, cfg, loss_of, [("a", 0.05), ("c", 0.005), ("d", 0.01)],
                 "transmission", row=4)


def test_position_grads_vs_fd(reflector):
    mats = _mats()

    def loss_at(tx):
        res = trace_paths(reflector, mats, RX, tx, Z, Z, 3.0, CFG)
        return (res.scatter.tau.sum() * C
                + res.scatter.a_te.abs().square().sum() * 1e6
                + res.los.tau.sum() * C)

    tx = torch.tensor(TX, requires_grad=True)
    loss_at(tx).backward()
    with torch.no_grad():
        fd = _fd(lambda x: loss_at(torch.as_tensor(x)), TX.copy(), 1e-3)
    _assert_fd(tx.grad.numpy(), fd, 0.05, 1e-6, "tx position")


def test_velocity_grads_vs_fd(reflector):
    mats = _mats()
    cfg = dataclasses.replace(CFG, parity="physical")
    tx_vel0 = np.array([[3.0, -1.0, 0.5]], np.float32)
    rx_vel0 = np.array([[-0.5, 2.0, 1.0]], np.float32)

    def loss(tx_vel, rx_vel):
        res = trace_paths(reflector, mats, RX, TX, rx_vel, tx_vel, 3.0, cfg)
        return (res.scatter.freq_shift.sum() * 1e-1
                + res.los.freq_shift.sum() * 1e-1)

    leaves = (torch.tensor(tx_vel0, requires_grad=True),
              torch.tensor(rx_vel0, requires_grad=True))
    g_tx, g_rx = torch.autograd.grad(loss(*leaves), leaves)
    with torch.no_grad():
        fd_tx = _fd(lambda v: loss(torch.as_tensor(v), rx_vel0),
                    tx_vel0.copy(), 1e-2)
        fd_rx = _fd(lambda v: loss(tx_vel0, torch.as_tensor(v)),
                    rx_vel0.copy(), 1e-2)
    _assert_fd(g_tx.numpy(), fd_tx, 0.02, 1e-6, "tx_vel")
    _assert_fd(g_rx.numpy(), fd_rx, 0.02, 1e-6, "rx_vel")
    assert g_tx.abs().sum() > 0 and g_rx.abs().sum() > 0


def test_mesh_velocity_grads_vs_fd(reflector):
    mats = _mats()

    def loss(vel):
        t2 = dataclasses.replace(reflector, velocity=torch.as_tensor(
            vel).expand(reflector.velocity.shape))
        res = trace_paths(t2, mats, RX, TX, Z, Z, 3.0, CFG)
        return res.scatter.freq_shift.sum() * 1e-1

    v0 = np.array([2.0, -1.0, 0.3], np.float32)
    v = torch.tensor(v0, requires_grad=True)
    loss(v).backward()
    with torch.no_grad():
        fd = _fd(loss, v0.copy(), 1e-2)
    _assert_fd(v.grad.numpy(), fd, 0.02, 1e-6, "mesh velocity")
    assert v.grad.abs().sum() > 0


def test_carrier_frequency_grads_vs_fd(reflector):
    mats = _mats()
    vel = np.array([[1.0, 0.0, 0.0]], np.float32)

    def loss(f_ghz):
        res = trace_paths(reflector, mats, RX, TX, Z, vel, f_ghz, CFG)
        return (res.scatter.a_te.abs().square().sum() * 1e6
                + res.scatter.freq_shift.sum() * 1e-6)

    f = torch.tensor(3.0, requires_grad=True)
    loss(f).backward()
    with torch.no_grad():
        fd = (float(loss(3.0 + 1e-3)) - float(loss(3.0 - 1e-3))) / 2e-3
    g = float(f.grad)
    assert abs(g) > 0
    _assert_fd(np.array(g), np.array(fd), 0.05, 1e-8, "f_ghz")


@pytest.mark.parametrize("parity", ["reference", "physical"])
def test_velocity_grads_match_jax(parity):
    """RX, TX and triangle velocities against ``jax.grad`` on the reflector
    with three RX: the loss weights every Doppler slot by a seeded factor,
    so the launch-sphere sum that cancels the TX term of a plain sum does
    not."""
    soa = jax_flatten(jax_reflector())
    rx = np.array([[0.1, -0.05, 0.4], [-0.2, 0.1, 0.6], [0.3, -0.3, 0.2]],
                  np.float32)
    tx = np.array([[0.0, 0.1, 0.5]], np.float32)
    rxv = np.array([[1.0, 2.0, 0.0], [0.0, -1.0, 0.5], [0.5, 0.5, -1.0]],
                   np.float32)
    txv = np.array([[0.5, -1.0, 0.25]], np.float32)
    tri_v = np.random.default_rng(3).normal(
        size=np.asarray(soa.velocity).shape).astype(np.float32)
    kw = dict(num_paths=256, num_bounces=2, parity=parity, keep_rays=False)
    K = 1 + 2 * 256
    w = np.random.default_rng(11).uniform(0.5, 1.5, (3, 1, K)).astype(
        np.float32)

    def jax_loss(rx_vel, tx_vel, v):
        res = jax_trace(dataclasses.replace(soa, velocity=v),
                        jax_materials(), rx, tx, rx_vel, tx_vel, 3.0,
                        JaxConfig(backend="jnp", **kw))
        nu = jnp.concatenate([res.los.freq_shift, res.scatter.freq_shift],
                             axis=-1)
        return jnp.sum(nu * w) * 1e-1

    ref = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(rxv), jnp.asarray(txv), jnp.asarray(tri_v))
    leaves = tuple(torch.tensor(x, requires_grad=True)
                   for x in (rxv, txv, tri_v))
    tris = dataclasses.replace(soa_from_jax(vars(soa)), velocity=leaves[2])
    res = trace_paths(tris, default_materials("cpu"), rx, tx, leaves[0],
                      leaves[1], 3.0, TracerConfig(backend="torch", **kw))
    nu = torch.cat([res.los.freq_shift, res.scatter.freq_shift], dim=-1)
    ours = torch.autograd.grad((nu * torch.as_tensor(w)).sum() * 1e-1,
                               leaves)
    names = ("rx_vel", "tx_vel", "tri_vel")
    for name, a, b in zip(names, ours, ref):
        b = torch.tensor(np.asarray(b))
        assert float(b.abs().max()) > 0, name
        checks.leaves_close({name: a}, {name: b}, checks.PATH_GRAD_RTOL,
                            checks.LEAF_ATOL, f"{parity} {name}")
