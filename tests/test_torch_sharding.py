"""``hermespy_rt_tpu_torch.parallel``: the trace over a ``(rays, tris)``
mesh of gloo ranks on the CPU, against the port's single-process trace and
the JAX package's ``trace_paths_sharded``.

The counterparts of ``tests/test_sharding.py``'s five tests.  The ranks run
as subprocesses of ``tests/_torch_sharding_worker.py`` (one spawn a mesh
shape: (2, 1) and (1, 2) in two processes, (2, 2) in four), as
``tests/test_distributed.py`` runs its; each writes its cases' arrays as an
npz.  Held here:

* outputs and ``rays_scatter.active`` bit-equal to the single-process
  trace on every mesh (every operation is per ray; the lexicographic
  minimum over the slabs is the scan's order), the same on every rank;
* gradients once and not once per rank: materials within rtol 1e-5 and
  1e-12 (``tests/test_sharding.py:67-70``) under ray sharding, and the RX
  and TX positions and the carrier frequency too (a summing backward of a
  collective would double them); the soup's within rtol 1e-4 under
  triangle sharding (``:96-99``), the replicated and the owner-masked
  payload table alike;
* against JAX ``trace_paths_sharded`` on the same mesh shape (conftest's
  virtual CPU devices; traced while the ranks run): the written slots within
  the port's tier (rtol 1e-4 with a floor of 1e-5 of the largest,
  ``testing.slots_agree``);
* mesh validation (too many shards, launch rays that do not divide), the
  fused path's warning under triangle sharding, and that no worker
  imported ``jax``.
"""
import _torch_threads  # noqa: F401  (first: the thread share)

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_sharding_worker as worker

import jax

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.parallel import default_mesh as jax_mesh
from hermespy_rt_tpu.parallel import trace_paths_sharded as jax_sharded
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS
from hermespy_rt_tpu_torch.testing import slots_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 1), (1, 2), (2, 2)]
TRI_MESHES = [(1, 2), (2, 2)]
CPU = torch.device("cpu")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(shape, out_dir):
    """Start the ranks of a ``shape`` mesh; returns their processes."""
    rays, tris = shape
    world = rays * tris
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_sharding_worker.py"),
         str(r), str(world), str(port), str(rays), str(tris), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        cwd=REPO) for r in range(world)]


def _finish(shape, procs, out_dir):
    """Wait for the ranks; returns every rank's arrays."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"mesh {shape}: a rank timed out")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"mesh {shape} rank {r}:\n{out[-3000:]}"
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(len(procs))]


def _jax_reference(shape):
    """JAX ``trace_paths_sharded`` on a mesh of ``shape`` over conftest's
    virtual CPU devices: the box under ray sharding only, the soup under
    triangle sharding (the worker's ``box`` and ``soup`` inputs)."""
    z = np.zeros((1, 3), np.float32)
    if shape[1] == 1:
        tris, rx, tx = js.flatten_scene(js.box_scene()), worker.RX, worker.TX
        cfg = JaxConfig(num_paths=512, num_bounces=2, backend="jnp",
                        keep_rays=True)
    else:
        tris = js.flatten_scene(js.random_soup_scene(300, seed=2),
                                pad_to=128)
        rx, tx = worker.SOUP_RX, worker.SOUP_TX
        cfg = JaxConfig(num_paths=256, num_bounces=2, backend="jnp",
                        keep_rays=False)
    res = jax_sharded(tris, jax_materials(), np.asarray(rx, np.float32),
                      np.asarray(tx, np.float32), z, z, worker.FREQ, cfg,
                      mesh=jax_mesh(*shape))
    out = {k: np.array(getattr(res.scatter, k)) for k in worker.OUTPUTS}
    if cfg.keep_rays:
        out["active"] = np.array(res.rays_scatter.active)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh shape, every rank's arrays and JAX's reference: the ranks
    of all three meshes run while JAX traces here."""
    assert len(jax.devices()) >= 4, "conftest must force 8 CPU devices"
    dirs = {shape: tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
            for shape in MESHES}
    procs = {shape: _start(shape, dirs[shape]) for shape in MESHES}
    try:
        jax_ref = {shape: _jax_reference(shape) for shape in MESHES}
    finally:
        arrays = {shape: _finish(shape, procs[shape], dirs[shape])
                  for shape in MESHES}
    return arrays, jax_ref


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


_SINGLE = {}


def single(name):
    """The case through the single-process ``trace_paths``."""
    if name not in _SINGLE:
        _SINGLE[name] = worker.CASES[name][0](worker.single, CPU)
    return _SINGLE[name]


def case(arrays, name):
    return {k.split("/", 1)[1]: v for k, v in arrays.items()
            if k.startswith(name + "/")}


def meta(arrays):
    return json.loads(str(arrays["meta"]))


def _bits_equal(ours, ref, label):
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v),
                                      err_msg=f"{label}: {k}")


def _grads_close(ours, ref, rtol, atol, label, keys=None):
    for k in keys or [f"d_{f}" for f in MATERIAL_FIELDS]:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{label}: {k}")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_matches_single_process(ranks, shape):
    """The box's outputs and ``rays_scatter.active`` bit for bit on every
    rank; the two TX / two RX trace too."""
    for r, arrays in enumerate(ranks[shape]):
        for name in ("box", "multi_tx"):
            _bits_equal(case(arrays, name), single(name),
                        f"{shape} rank {r} {name}")


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_return_the_same_result(ranks, shape):
    first = ranks[shape][0]
    for r, arrays in enumerate(ranks[shape][1:], 1):
        for k in first:
            if k != "meta":
                np.testing.assert_array_equal(arrays[k], first[k],
                                              err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_gradients_match(ranks, shape):
    """Material gradients within rtol 1e-5 (``tests/test_sharding.py``'s
    ray-sharded tier), and the RX / TX position and frequency gradients:
    summed over the ray shards once, not once per rank."""
    ref = single("grad")
    ours = case(ranks[shape][0], "grad")
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-6)
    _grads_close(ours, ref, 1e-5, 1e-12, f"{shape}")
    for k in ("d_rx", "d_tx", "d_f"):
        assert np.abs(ref[k]).max() > 0, k
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=f"{shape}: {k}")


@pytest.mark.parametrize("shape", MESHES)
def test_fused_step(ranks, shape):
    """``bench.py``'s step (``shade="fused"``): per ray shard the fused
    loop, outputs the single-process bits and material gradients within
    rtol 1e-5; under triangle sharding a warning and the op path, whose
    outputs agree within the tier and gradients within rtol 1e-4."""
    ref, arrays = single("fused"), ranks[shape][0]
    ours = case(arrays, "fused")
    warned = meta(arrays)["warnings"]["fused"]
    if shape[1] == 1:
        assert warned == []
        _bits_equal({k: ours[k] for k in worker.OUTPUTS},
                    {k: ref[k] for k in worker.OUTPUTS}, f"{shape}")
        _grads_close(ours, ref, 1e-5, 1e-12, f"{shape}")
    else:
        assert warned == ["shade='fused' falling back to the op path: "
                          "tri-sharded scene access"]
        for k in worker.OUTPUTS:
            slots_agree(torch.as_tensor(ref[k]), torch.as_tensor(ours[k]), k)
        _grads_close(ours, ref, 1e-4, 1e-12, f"{shape}")


@pytest.mark.parametrize("shape,name", [
    (shape, name) for shape in MESHES
    for name in ("soup", "soup_masked", "soup_walk")
    if name == "soup" or shape[1] > 1])
def test_tri_sharded_soup(ranks, shape, name):
    """``random_soup_scene(300, seed=2)``: the loss within rtol 1e-6 and
    material gradients within rtol 1e-4 (``tests/test_sharding.py:96-99``)
    of the single process, with the replicated payload table, the
    owner-masked fetch (``tri_shard_table=True``), and every query walking
    the slabs under physical parity; outputs the single-process bits."""
    ref, ours = single(name), case(ranks[shape][0], name)
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-6)
    _grads_close(ours, ref, 1e-4, 1e-12, f"{shape} {name}")
    _bits_equal({k: ours[k] for k in worker.OUTPUTS},
                {k: ref[k] for k in worker.OUTPUTS}, f"{shape} {name}")


@pytest.mark.parametrize("shape,name", [
    (shape, name) for shape in MESHES
    for name in ("geometry", "geometry_masked")
    if name == "geometry" or shape[1] > 1])
def test_geometry_and_velocity_gradients_match(ranks, shape, name):
    """The gradients to the triangles' vertices, normals and velocities and
    to the RX and TX velocities (physical parity, a loss on the power and
    the Doppler slots) against the single process, replicated and masked
    table: once and not once per rank (a summing backward of a collective
    doubles them), the scene's summed over the slabs and the padding cut.
    Within rtol 1e-4 (``tests/test_sharding.py:96-99``), with a floor of
    1e-5 of the leaf's largest for the entries summed to near zero."""
    ref, ours = single(name), case(ranks[shape][0], name)
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-6)
    _grads_close(ours, ref, 1e-4, 1e-12, f"{shape} {name}")
    for k in ([f"d_{f}" for f in worker.GEOMETRY_LEAVES]
              + ["d_rx_vel", "d_tx_vel"]):
        assert np.abs(ref[k]).max() > 0, k
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=f"{shape} {name}: {k}")


@pytest.mark.parametrize("shape", TRI_MESHES)
def test_masked_fetch_matches_replicated(ranks, shape):
    rep, masked = (case(ranks[shape][0], n) for n in ("soup", "soup_masked"))
    _bits_equal({k: masked[k] for k in worker.OUTPUTS},
                {k: rep[k] for k in worker.OUTPUTS}, f"{shape}")
    _grads_close(masked, rep, 1e-4, 1e-12, f"{shape} masked")


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_validation(ranks, shape):
    """Too many shards for the ranks, and 101 launch rays over two ray
    shards, raise ``ValueError`` (``tests/test_sharding.py::
    test_mesh_validation``; 100 divides over 2, so 101)."""
    errors = meta(ranks[shape][0])["errors"]
    assert any("needs" in e for e in errors)
    assert any("must divide" in e for e in errors) == (shape[0] > 1)


@pytest.mark.parametrize("shape", MESHES)
def test_workers_leave_jax_out(ranks, shape):
    for arrays in ranks[shape]:
        m = meta(arrays)
        assert m["jax_imported"] is False
        assert m["route"] == "device"     # gloo with CPU tensors
        assert m["collectives"]["calls"] > 0


@pytest.mark.parametrize("shape", MESHES)
def test_against_jax(runs, shape):
    """The outputs against JAX ``trace_paths_sharded`` on the same mesh
    shape (the box under ray sharding, the soup under triangle sharding),
    within the port's tier; ``rays_scatter.active`` alike on more than
    99.5% of the slots (``tests/test_torch_tracer.py``)."""
    ranks, jax_ref = runs
    ref = jax_ref[shape]
    ours = case(ranks[shape][0], "box" if shape[1] == 1 else "soup")
    for k in worker.OUTPUTS:
        slots_agree(torch.as_tensor(ref[k]), torch.as_tensor(ours[k]), k)
    if "active" in ref:
        assert ref["active"].shape == ours["active"].shape
        assert (ref["active"] == ours["active"]).mean() > 0.995
