"""One rank of ``hermespy_rt_tpu_torch.parallel.trace_paths_sharded``.

    python tests/_torch_sharding_worker.py RANK WORLD PORT RAYS TRIS OUT_DIR \
        [DEVICE] [CASE ...]

Joins a gloo process group of ``WORLD`` ranks at ``tcp://localhost:PORT``,
builds a ``(RAYS, TRIS)`` mesh, runs every case of :data:`CASES` meant for
that mesh (or the ``CASE``s named) through the sharded trace on ``DEVICE``
("cpu" by default) and writes ``OUT_DIR/rank<RANK>.npz``: the cases'
arrays as ``<case>/<name>``, and ``meta`` (JSON: the warnings, whether
``jax`` was imported, the collective route and counts).  The tests run the
same case functions through the single-process ``trace_paths`` and compare.
This file imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import torch

from hermespy_rt_tpu_torch import (TracerConfig, default_materials,
                                   trace_paths)
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.scene import (box_scene, flatten_scene,
                                         random_soup_scene)

RX = [[1.0, 2.0, 1.5]]
TX = [[-2.0, -1.0, 2.5]]
SOUP_RX = [[5.0, 5.0, 5.0]]
SOUP_TX = [[-5.0, -5.0, 5.0]]
FREQ = 3.0
OUTPUTS = ("a_te", "a_tm", "tau", "freq_shift", "directions_rx")
GEOMETRY_LEAVES = ("v0", "normal", "velocity")
# the canyon stand-in of chip_smoke.py and bench.py
CANYON = dict(num_triangles=234, seed=0, extent=90.0, tri_size=8.0)
CANYON_TX = [[-20.0, -10.0, 10.0]]
CANYON_RX = [[10.0, 5.0, 2.0]]


def _outputs(res, keep_rays=False):
    out = {f: getattr(res.scatter, f).detach().cpu().numpy() for f in OUTPUTS}
    out["los_a_te"] = res.los.a_te.detach().cpu().numpy()
    if keep_rays:
        out["active"] = res.rays_scatter.active.cpu().numpy()
    return out


def _power(res):
    return (res.scatter.a_te.abs().square().sum()
            + res.scatter.a_tm.abs().square().sum()) * 1e9


def _material_grads(mats):
    return {f"d_{f}": (torch.zeros_like(getattr(mats, f)) if getattr(
        mats, f).grad is None else getattr(mats, f).grad).cpu().numpy()
        for f in MATERIAL_FIELDS}


def case_box(trace, dev):
    """Outputs and ``rays_scatter.active`` on the box (512 paths, B = 2,
    rays kept), as ``tests/test_sharding.py``."""
    cfg = TracerConfig(num_paths=512, num_bounces=2, keep_rays=True)
    with torch.no_grad():
        res = trace(flatten_scene(box_scene(), device=dev),
                    default_materials(dev), RX, TX, [[0.0] * 3], [[0.0] * 3],
                    FREQ, cfg)
    return _outputs(res, keep_rays=True)


def case_grad(trace, dev):
    """Gradients of the power to the materials, the RX and TX positions
    and the carrier frequency on the box (op path, 256 paths, B = 2)."""
    cfg = TracerConfig(num_paths=256, num_bounces=2, keep_rays=False)
    mats = default_materials(dev)
    rx = torch.tensor(RX, device=dev, requires_grad=True)
    tx = torch.tensor(TX, device=dev, requires_grad=True)
    f = torch.tensor(FREQ, device=dev, requires_grad=True)
    res = trace(flatten_scene(box_scene(), device=dev), mats, rx, tx,
                [[0.0] * 3], [[0.0] * 3], f, cfg)
    loss = _power(res)
    loss.backward()
    return {"loss": loss.detach().cpu().numpy(), **_material_grads(mats),
            "d_rx": rx.grad.cpu().numpy(), "d_tx": tx.grad.cpu().numpy(),
            "d_f": f.grad.cpu().numpy()}


def case_fused(trace, dev):
    """The material-calibration step of ``bench.py`` (``shade="fused"``,
    ``grad_positions=False``) on the box: outputs and material gradients."""
    cfg = TracerConfig(num_paths=256, num_bounces=2, keep_rays=False,
                       shade="fused", grad_positions=False,
                       grad_geometry=False, compact_rays=True)
    mats = default_materials(dev)
    res = trace(flatten_scene(box_scene(), device=dev), mats, RX, TX,
                [[0.0] * 3], [[0.0] * 3], FREQ, cfg)
    _power(res).backward()
    return {**_outputs(res), **_material_grads(mats)}


def case_multi_tx(trace, dev):
    """Two TX and two RX on the box (256 paths, B = 2)."""
    cfg = TracerConfig(num_paths=256, num_bounces=2)
    tx = [[-2.0, -1.0, 2.5], [2.0, 1.0, 1.5]]
    rx = [[1.0, 2.0, 1.5], [0.0, 0.0, 3.0]]
    z = [[0.0] * 3] * 2
    with torch.no_grad():
        res = trace(flatten_scene(box_scene(), device=dev),
                    default_materials(dev), rx, tx, z, z, FREQ, cfg)
    return _outputs(res)


def _soup(trace, dev, **kw):
    cfg = TracerConfig(num_paths=256, num_bounces=2, keep_rays=False, **kw)
    mats = default_materials(dev)
    res = trace(flatten_scene(random_soup_scene(300, seed=2), pad_to=128,
                              device=dev), mats, SOUP_RX, SOUP_TX,
                [[0.0] * 3], [[0.0] * 3], FREQ, cfg)
    loss = _power(res)
    loss.backward()
    return {**_outputs(res), "loss": loss.detach().cpu().numpy(),
            **_material_grads(mats)}


def case_soup(trace, dev):
    """``random_soup_scene(300, seed=2)``: outputs and material gradients,
    the payload table replicated (``tri_shard_table="auto"``)."""
    return _soup(trace, dev)


def case_soup_masked(trace, dev):
    """As :func:`case_soup` with the owner-masked fetch
    (``tri_shard_table=True``)."""
    return _soup(trace, dev, tri_shard_table=True)


def case_soup_walk(trace, dev):
    """The soup under physical parity with every query walking (any-hit
    shadow queries), the payload table masked: material gradients."""
    return _soup(trace, dev, parity="physical", walk=True,
                 tri_shard_table=True)


def _geometry(trace, dev, **kw):
    cfg = TracerConfig(num_paths=256, num_bounces=2, keep_rays=False,
                       parity="physical", **kw)
    mats = default_materials(dev)
    base = flatten_scene(random_soup_scene(300, seed=2), pad_to=128,
                         device=dev)
    leaves = {f: getattr(base, f).clone().requires_grad_()
              for f in GEOMETRY_LEAVES}
    rx_vel = torch.tensor([[0.5, -1.0, 0.25]], device=dev,
                          requires_grad=True)
    tx_vel = torch.tensor([[1.0, 2.0, 0.0]], device=dev, requires_grad=True)
    res = trace(dataclasses.replace(base, **leaves), mats, SOUP_RX, SOUP_TX,
                rx_vel, tx_vel, FREQ, cfg)
    nu = torch.cat([res.los.freq_shift, res.scatter.freq_shift], dim=-1)
    w = torch.as_tensor(np.random.default_rng(11).uniform(
        0.5, 1.5, tuple(nu.shape)).astype(np.float32), device=dev)
    power = _power(res)
    loss = power / power.detach() + (nu * w).sum() * 1e-1
    loss.backward()
    return {"loss": loss.detach().cpu().numpy(), **_material_grads(mats),
            **{f"d_{f}": x.grad.cpu().numpy() for f, x in leaves.items()},
            "d_rx_vel": rx_vel.grad.cpu().numpy(),
            "d_tx_vel": tx_vel.grad.cpu().numpy()}


def case_geometry(trace, dev):
    """The soup under physical parity with the triangles' first vertices,
    normals and velocities, the RX and TX velocities and the materials as
    leaves, the payload table replicated: the loss is the power over its
    own value plus every Doppler slot weighted by a seeded factor."""
    return _geometry(trace, dev)


def case_geometry_masked(trace, dev):
    """As :func:`case_geometry` with the owner-masked fetch
    (``tri_shard_table=True``): the scene's gradients summed over the
    slabs."""
    return _geometry(trace, dev, tri_shard_table=True)


def case_card_step(trace, dev):
    """``bench.py``'s step at 2^16 paths on the canyon stand-in (B = 3,
    nrx 1, the fused path, reference parity): outputs and material
    gradients."""
    cfg = TracerConfig(num_paths=1 << 16, num_bounces=3, keep_rays=False,
                       shade="fused", grad_positions=False,
                       grad_geometry=False, compact_rays=True)
    mats = default_materials(dev)
    res = trace(flatten_scene(random_soup_scene(**CANYON), device=dev), mats,
                CANYON_RX, CANYON_TX, [[0.0] * 3], [[0.0] * 3], FREQ, cfg)
    _power(res).backward()
    return {**_outputs(res), **_material_grads(mats)}


# case name -> (function, the mesh shapes it runs on)
CASES = {"box": (case_box, "all"), "grad": (case_grad, "all"),
         "fused": (case_fused, "all"), "multi_tx": (case_multi_tx, "all"),
         "soup": (case_soup, "all"), "soup_masked": (case_soup_masked, "tris"),
         "soup_walk": (case_soup_walk, "tris"),
         "geometry": (case_geometry, "all"),
         "geometry_masked": (case_geometry_masked, "tris"),
         "card_step": (case_card_step, "named")}


def single(tris, mats, rx, tx, rxv, txv, f, cfg):
    """The single-process trace the sharded one is held against."""
    return trace_paths(tris, mats, rx, tx, rxv, txv, f, cfg)


def main(argv):
    rank, world, port, rays, tris_n = map(int, argv[:5])
    out_dir = argv[5]
    dev = torch.device(argv[6] if len(argv) > 6 else "cpu")
    names = argv[7:] or [n for n, (_, on) in CASES.items()
                         if on == "all" or (on == "tris" and tris_n > 1)]
    from hermespy_rt_tpu_torch.parallel import (default_mesh,
                                                initialize_distributed,
                                                trace_paths_sharded)
    from hermespy_rt_tpu_torch.parallel import sharding

    if dev.type == "cuda":     # every rank on the first card
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    mesh = default_mesh(rays, tris_n, device_type=dev.type)
    trace = lambda *a: trace_paths_sharded(*a, mesh=mesh)  # noqa: E731
    arrays, meta = {}, {"warnings": {}}
    for name in names:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for k, v in CASES[name][0](trace, dev).items():
                arrays[f"{name}/{k}"] = np.asarray(v)
        meta["warnings"][name] = [str(w.message) for w in caught
                                  if "falling back" in str(w.message)]
    # a mesh of more shards than ranks, and launch rays that do not divide
    errors = []
    try:
        default_mesh(2 * world, 1, device_type=dev.type)
    except ValueError as e:
        errors.append(str(e))
    if rays > 1:
        try:
            trace(flatten_scene(box_scene(), device=dev),
                  default_materials(dev), RX, TX, [[0.0] * 3], [[0.0] * 3],
                  FREQ, TracerConfig(num_paths=101, num_bounces=1))
        except ValueError as e:
            errors.append(str(e))
    meta.update(errors=errors, jax_imported="jax" in sys.modules,
                route=sharding.collective_route(
                    mesh.get_group("rays" if rays > 1 else "tris"),
                    torch.zeros(1, device=dev)),
                collectives=dict(sharding.COLLECTIVES))
    arrays["meta"] = np.array(json.dumps(meta))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
