"""PyTorch port vs JAX package: the bench step that ``hrt-torch-bench``
times (``hermespy_rt_tpu_torch/bench.py``).

The CLI's one line; the step's loss and material gradients against the JAX
package's ``trace_paths(shade="xla", backend="jnp")`` value-and-gradient on
the same scene and flags, at nrx 1 (the fused path, bench.py's choice there)
and nrx 4 (``shade="xla"``): the loss within ``SUM_RTOL`` (a sum of ~10^4
f32 terms in another order), each material leaf within ``PATH_GRAD_RTOL``
of its largest magnitude (``testing.py``); and the port's flags against the
text of the repository's ``bench.py``."""
import _torch_threads  # noqa: F401  (first: the thread share)

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hermespy_rt_tpu.scene as js
from hermespy_rt_tpu.config import TracerConfig as JaxConfig
from hermespy_rt_tpu.materials import default_materials as jax_materials
from hermespy_rt_tpu.tracer import trace_paths as jax_trace
from hermespy_rt_tpu_torch import bench
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.cli import bench_main
from hermespy_rt_tpu_torch.materials import MATERIAL_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = 1 << 12
TPU_ONLY = ("precision", "fuse4", "gather", "fetch_bwd")


def _literal(node):
    """A literal, where ``dict(k=v, ...)`` counts as one."""
    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict":
        return {kw.arg: _literal(kw.value) for kw in node.keywords}
    if isinstance(node, ast.Dict):
        return {_literal(k): _literal(v)
                for k, v in zip(node.keys, node.values)}
    return ast.literal_eval(node)


def _bench_py_value(name):
    """What bench.py assigns to ``name`` at module level, read from its
    text (importing it would import the JAX package's bench)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    value, = [node.value for node in tree.body
              if isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", "") == name]
    return _literal(value)


def test_bench_flags_are_bench_py_without_tpu_keys():
    flags = _bench_py_value("BENCH_FLAGS")
    want = {k: v for k, v in flags.items() if k not in TPU_ONLY}
    assert bench.BENCH_FLAGS == want
    assert set(flags) - set(want) == set(TPU_ONLY)
    assert bench.SHADE_BY_NRX == _bench_py_value("SHADE_BY_NRX")
    assert [bench.shade_for(n) for n in (1, 4, 16)] == ["fused", "xla", "xla"]


def test_bench_main_prints_its_line():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert bench_main(["--paths", "4096", "--bounces", "2",
                           "--device", "cpu"]) == 0
    line = json.loads(out.getvalue())
    assert sorted(line) == ["queries", "rays_per_s", "wall_s"]
    assert line["queries"] == 2 * 4096 * 2
    assert np.isfinite(line["rays_per_s"]) and line["rays_per_s"] > 0
    assert line["wall_s"] > 0


def test_bench_step_refuses_a_missing_card_and_unknown_shades():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.BenchStep(64)
    with pytest.raises(ValueError, match="shade"):
        bench.BenchStep(64, device="cpu", shade="pallas")


def _jax_scene():
    if os.path.exists(bench.CANYON):
        return js.load_hrt(bench.CANYON)
    return js.random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0)


@pytest.mark.parametrize("nrx", [1, 4])
def test_bench_step_matches_jax(nrx):
    step = bench.BenchStep(PATHS, 3, nrx, device="cpu")
    assert step.shade == ("fused" if nrx == 1 else "xla")
    _, loss = step()
    grads = checks.grads_of(step.mats)

    cfg = JaxConfig(num_paths=PATHS, num_bounces=3, backend="jnp",
                    shade="xla", keep_rays=False, unroll_bounces=True,
                    compact_rays=True, launch_order="coherent",
                    grad_geometry=False)
    tris = js.flatten_scene(_jax_scene())
    rx = jnp.asarray(bench.rx_positions(nrx))
    tx = jnp.asarray(bench.TX, jnp.float32)

    def loss_fn(mats):
        res = jax_trace(tris, mats, rx, tx, jnp.zeros_like(rx),
                        jnp.zeros_like(tx), jnp.float32(bench.FREQ_GHZ), cfg)
        return (jnp.sum(jnp.abs(res.scatter.a_te) ** 2)
                + jnp.sum(jnp.abs(res.scatter.a_tm) ** 2)) * 1e9

    ref_loss, ref_g = jax.jit(jax.value_and_grad(loss_fn))(jax_materials())
    ref_loss = float(ref_loss)
    assert ref_loss > 0
    assert abs(float(loss.detach()) - ref_loss) <= checks.SUM_RTOL * ref_loss
    checks.leaves_close(grads, {f: torch.tensor(np.asarray(getattr(ref_g, f)))
                                for f in MATERIAL_FIELDS},
                        checks.PATH_GRAD_RTOL, checks.LEAF_ATOL,
                        f"nrx={nrx}: material gradients")
    assert any(float(g.abs().max()) > 0 for g in grads.values())
