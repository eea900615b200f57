"""PyTorch port vs JAX package: the op path with every Pallas kernel.

The port's ``trace_paths(shade="pallas", cull=True, compact_rays=True)``
(the culled query, the row gather and its scatter-add backward, the
reflection-half shading node; on the CPU each kernel's plain version) is
held against JAX ``trace_paths`` under ``TracerConfig(backend="pallas",
walk=False, cull=True, gather="onehot_pallas", fetch_bwd="pallas",
shade="pallas", compact_rays=True, block_tris=128)``, whose Pallas kernels
(``_kernel_culled``, ``_fwd_kernel`` and ``_bwd_kernel`` of the fetch,
``_shade_a_kernel``) run in interpret mode: a soup and the box scene, 512
paths, B = 2, two RX, both parities, ``grad_geometry`` True and False.
Values: the written scatter slots agree (> 99.5%, within rtol 1e-4 plus 1e-5
of the largest, ``tests/test_torch_tracer.py``'s tier) and the loss to
1e-5; gradients to the materials, the RX and TX positions, the carrier
frequency and the vertices within 3e-5 of each leaf's largest magnitude plus
1e-16 (``tests/test_torch_stages.py``'s tier)."""
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
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import TracerConfig, trace_paths
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.convert import materials_from_jax, soa_from_jax
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS

FREQ = 3.0
SCENES = {
    "soup": (lambda m: m.random_soup_scene(234),
             [[10.0, 5.0, 2.0], [11.5, 3.0, 2.25]], [[-20.0, -10.0, 10.0]]),
    "box": (lambda m: m.box_scene(),
            [[0.5, 0.2, 1.0], [-1.0, 2.0, 0.5]], [[0.0, 0.0, 1.5]]),
}


def _scene(build, seed=3):
    """The flattened JAX scene with a velocity per triangle drawn from a
    seed, so that the Doppler chains carry values."""
    soa = js.flatten_scene(build(js))
    vel = np.random.default_rng(seed).uniform(-2.0, 2.0, soa.velocity.shape)
    return dataclasses.replace(soa, velocity=jnp.asarray(vel, jnp.float32))


def _loss(a_te, a_tm, tau, freq_shift, xp):
    return ((xp.sum(xp.abs(a_te) ** 2) + xp.sum(xp.abs(a_tm) ** 2)) * 1e9
            + xp.sum(tau) * 1e3 + xp.sum(freq_shift) * 1e-3)


@pytest.mark.parametrize("name,parity,grad_geometry", [
    ("soup", "reference", True), ("soup", "physical", False),
    ("box", "reference", False), ("box", "physical", True)])
def test_pallas_op_path_matches_jax(name, parity, grad_geometry):
    build, rx, tx = SCENES[name]
    soa = _scene(build)
    rx = np.asarray(rx, np.float32)
    tx = np.asarray(tx, np.float32)
    # no TX velocity: its launch Doppler summed over the Fibonacci sphere
    # cancels to ~1e-4 of its terms (tests/test_torch_stages.py)
    rxv, txv = np.zeros_like(rx), np.zeros_like(tx)
    jcfg = JaxConfig(num_paths=512, num_bounces=2, parity=parity,
                     backend="pallas", walk=False, cull=True,
                     gather="onehot_pallas", fetch_bwd="pallas",
                     shade="pallas", compact_rays=True, block_tris=128,
                     keep_rays=False, grad_geometry=grad_geometry)

    def jax_loss(m, rx_, tx_, f, v0):
        sc = jax_trace(dataclasses.replace(soa, v0=v0), m, rx_, tx_, rxv,
                       txv, f, jcfg).scatter
        return _loss(sc.a_te, sc.a_tm, sc.tau, sc.freq_shift, jnp), sc

    (loss_j, sc_j), grads_j = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jax_materials(), jnp.asarray(rx), jnp.asarray(tx), jnp.float32(FREQ),
        soa.v0)

    mats = materials_from_jax(vars(jax_materials()))
    tris = soa_from_jax(vars(soa))
    v0 = tris.v0.clone().requires_grad_()
    leaves = dict(rx=torch.tensor(rx, requires_grad=True),
                  tx=torch.tensor(tx, requires_grad=True),
                  f=torch.tensor(FREQ, requires_grad=True), v0=v0)
    cfg = TracerConfig(num_paths=512, num_bounces=2, parity=parity,
                       shade="pallas", cull=True, compact_rays=True,
                       keep_rays=False, grad_geometry=grad_geometry)
    with checks.recording_fused() as calls:
        res = trace_paths(dataclasses.replace(tris, v0=v0), mats,
                          leaves["rx"], leaves["tx"], rxv, txv, leaves["f"],
                          cfg)
        sc = res.scatter
        loss = _loss(sc.a_te, sc.a_tm, sc.tau, sc.freq_shift, torch)
        loss.backward()
    # the path went through each kernel's wrapper: per bounce one shading
    # node and a bounce and a shadow query; the LoS query; one payload fetch
    # per bounce (and the occluder normals under reference parity) besides
    # the table's eta rows, each with its scatter-add backward
    n_fetch = 1 + 2 * (1 + (parity == "reference"))
    assert [len(calls[k]) for k in ("shade_a", "nearest_hit_culled",
                                    "gather")] == [2, 5, n_fetch]
    assert len(calls["scatter_add"]) == n_fetch - 2 * (
        (parity == "reference") and not grad_geometry)

    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for f in checks.OUTPUT_FIELDS:
        checks.slots_agree(torch.as_tensor(np.array(getattr(sc_j, f))),
                           getattr(sc, f), f)
    g_m, g_rx, g_tx, g_f, g_v0 = grads_j
    checks.leaves_close(checks.grads_of(mats),
                        {f: torch.tensor(np.asarray(getattr(g_m, f)))
                         for f in MATERIAL_FIELDS}, checks.LEAF_RTOL,
                        checks.LEAF_ATOL, "material gradients")
    for key, ref in (("rx", g_rx), ("tx", g_tx), ("f", g_f), ("v0", g_v0)):
        ours = leaves[key].grad
        ours = torch.zeros(np.shape(ref)) if ours is None else ours
        checks.leaves_close({key: ours}, {key: torch.tensor(np.asarray(ref))},
                            checks.LEAF_RTOL, checks.LEAF_ATOL,
                            f"{key} gradient")
    assert float(np.abs(np.asarray(g_rx)).max()) > 0
    assert (float(np.abs(np.asarray(g_v0)).max()) > 0) == grad_geometry
