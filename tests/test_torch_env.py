"""The test processes' own setting: every port test file imports
``tests/_torch_threads.py`` first, and an xdist worker runs torch on its
share of the cores."""
import _torch_threads  # noqa: F401  (first: the thread share)

import ast
import os
import pathlib

import torch

TESTS = pathlib.Path(__file__).parent


def _first_import(path):
    tree = ast.parse(path.read_text())
    return next(node for node in tree.body
                if isinstance(node, (ast.Import, ast.ImportFrom))
                and getattr(node, "module", None) != "__future__")


def test_every_port_test_file_imports_the_thread_share_first():
    files = sorted(TESTS.glob("test_torch_*.py"))
    assert len(files) > 20
    for path in files:
        first = _first_import(path)
        assert (isinstance(first, ast.Import)
                and [a.name for a in first.names] == ["_torch_threads"]), (
            path.name)


def test_torch_threads_are_the_worker_share(monkeypatch):
    """In an xdist worker torch runs ``os.cpu_count()`` over the workers'
    threads, at least one; outside one the module sets nothing."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        assert _torch_threads.THREADS == max(
            1, os.cpu_count() // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
        assert torch.get_num_threads() == _torch_threads.THREADS
    else:
        assert _torch_threads.THREADS is None
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    for workers, want in ((6, 1), (4, 2), (1, 8), (16, 1)):
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
        assert _torch_threads.share() == want
    monkeypatch.delenv("PYTEST_XDIST_WORKER")
    assert _torch_threads.share() is None
