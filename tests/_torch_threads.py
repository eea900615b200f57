"""A fair share of the cores for torch in each test worker.

torch's intra-op pool defaults to one thread per core in every process.
Under pytest-xdist each worker keeps that default, so six workers on eight
cores ran up to 48 torch threads beside JAX's own pools, and the port's
tests spent most of their time fighting each other for the cores.  On an
8-core Xeon host, ``test_torch_walk.py::test_trace_walk_equals_brute_and_jax
[physical-xla-1]`` takes 12.0 s alone; six copies of it at once took
106.3-107.8 s each on torch's default pool and 11.9-13.0 s each on one
thread.  The six heaviest port files under ``-n 6 --dist loadfile`` took
1,388 worker-seconds and 294 s of wall on the default pool, 401 and 121 on
one thread, with the same passes.

Every ``tests/test_torch_*.py`` imports this module first (``--dist
loadfile`` may hand a worker any port file first).  In an xdist worker it
sets torch's intra-op threads to the cores over the workers, at least one;
in a single process (no ``PYTEST_XDIST_WORKER``, e.g. the card tests run
alone) it leaves torch's default alone.  The share is worked out from what
the process observes; nothing sets it.
"""
import os

import torch


def share():
    """The intra-op threads of one xdist worker, ``os.cpu_count()`` over the
    workers and at least one; None outside an xdist worker."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return None
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    return max(1, (os.cpu_count() or 1) // workers)


THREADS = share()
if THREADS is not None:
    torch.set_num_threads(THREADS)
