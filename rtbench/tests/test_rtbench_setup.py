"""What keeps set-up short and steady: the calibration entry's Adam is
``torch.optim.Adam`` bit for bit without importing ``torch._dynamo``, and
a run keeps the interpreter's bytecode in its checkout."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench.entries.calibration import Adam  # noqa: E402
from rtbench.tests.tiny import REPO, RTBENCH  # noqa: E402


@pytest.mark.parametrize("foreach", [True, False])
def test_adam_is_torch_adam_bit_for_bit(foreach):
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(5, generator=gen).requires_grad_(True)
    c = torch.randn(3, generator=gen).requires_grad_(True)
    a2 = a.detach().clone().requires_grad_(True)
    c2 = c.detach().clone().requires_grad_(True)
    ours = Adam([{"params": [a], "lr": 1e-2}, {"params": [c], "lr": 1e-4}])
    ref = torch.optim.Adam([{"params": [a2], "lr": 1e-2},
                            {"params": [c2], "lr": 1e-4}], foreach=foreach)
    for _ in range(5):
        ga, gc = torch.randn(5, generator=gen), torch.randn(3, generator=gen)
        ours.zero_grad(set_to_none=True)
        ref.zero_grad(set_to_none=True)
        a.grad, c.grad, a2.grad, c2.grad = ga, gc, ga.clone(), gc.clone()
        ours.step()
        ref.step()
    assert torch.equal(a, a2) and torch.equal(c, c2)
    assert torch.equal(ours.state[a]["exp_avg"], ref.state[a2]["exp_avg"])


def test_adam_imports_no_dynamo():
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from rtbench.entries.calibration import Adam\n"
            "p = torch.zeros(3, requires_grad=True)\n"
            "o = Adam([{'params': [p], 'lr': 1e-2}])\n"
            "p.grad = torch.ones(3)\n"
            "o.step()\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_run_keeps_bytecode_in_its_checkout(tmp_path):
    shutil.copytree(RTBENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                    "soup234.calib.nrx16", "--seed", "1", "--seconds", "1"],
                   cwd=tmp_path, capture_output=True, text=True, timeout=120,
                   env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                            PYTHONDONTWRITEBYTECODE="1"))
    cache = tmp_path / "_rtbench_pycache"
    assert any(name.endswith(".pyc") for _, _, names in os.walk(cache)
               for name in names)
