"""The run's own guards: banned modules by whole top-level name, no card,
no program beside the benchmark."""
import os
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness  # noqa: E402
from rtbench.tests.tiny import REPO, RTBENCH  # noqa: E402


@pytest.mark.parametrize("modules,found", [
    (["hermespy_rt_tpu_torch", "hermespy_rt_tpu_torch.api", "torch"], []),
    (["hermespy_rt_tpu", "hermespy_rt_tpu_torch"], ["hermespy_rt_tpu"]),
    (["hermespy_rt_tpu.tracer"], ["hermespy_rt_tpu"]),
    (["jaxlib.xla_client", "jax._src"], ["jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "jax_utils"], []),
    (["flax.linen"], ["flax"]),
])
def test_banned_modules_compare_whole_top_level_names(modules, found):
    assert harness.banned_modules(modules) == found


def test_this_process_holds_no_banned_module_after_a_run_import():
    import rtbench.harness  # noqa: F401
    import rtbench.reference.tracer  # noqa: F401
    assert harness.banned_modules() == []


def _run(cwd):
    return subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload",
         "soup234.calib.nrx16", "--seed", "1", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(RTBENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_reference_imports_nothing_of_the_program():
    import ast
    for name in ("tracer.py", "__init__.py"):
        tree = ast.parse(open(os.path.join(RTBENCH, "reference",
                                           name)).read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        tops = {m.split(".")[0] for m in mods}
        assert tops <= {"__future__", "dataclasses", "typing", "numpy",
                        "torch"}, tops
