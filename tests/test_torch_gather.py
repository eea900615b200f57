"""PyTorch port vs JAX package: the row fetch and its backward.

``gather_plain`` (the plain version of the row-gather kernel,
``csrc/gather.cu``) must equal the JAX package's Pallas fetch
(``pallas_onehot_fetch`` and its transposed form ``pallas_onehot_fetch_t``,
interpret mode) bit for bit: both are exact copies of table rows.
``gather_rows``' backward, the scatter-add's plain version on the CPU, with
and without its column window, is held against ``jax.vjp`` of
``pallas_onehot_fetch_t`` with and without ``bwd_cols`` (``bwd="pallas"``:
``pallas_scatter_add``) to 3e-5 of each table row's largest magnitude (the
sums are taken in other orders).  The kernel itself is tested on the card by
``tests/test_torch_cuda.py``."""
import _torch_threads  # noqa: F401  (first: the thread share)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hermespy_rt_tpu.ops.fetch_pallas import (pallas_onehot_fetch,
                                              pallas_onehot_fetch_t)
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.ops.fetch import gather_plain
from hermespy_rt_tpu_torch.ops.fetch_cuda import gather, gather_rows

T, C = 256, 27


def _inputs(seed, N):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(T, C))
             * 10.0 ** rng.integers(-6, 6, (T, C))).astype(np.float32)
    idx = rng.integers(0, T, N).astype(np.int32)
    idx[:300] = 7                                    # a long run of one row
    return table, idx


def test_gather_plain_equals_pallas_fetch():
    table, idx = _inputs(0, 5000)
    ours = gather_plain(torch.as_tensor(table), torch.as_tensor(idx))
    ref = pallas_onehot_fetch(jnp.asarray(idx), jnp.asarray(table), True)
    ref_t = pallas_onehot_fetch_t(jnp.asarray(idx), jnp.asarray(table), True)
    assert ours.shape == (5000, C)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy().T, np.asarray(ref_t))
    # the CPU wrapper runs the plain version, with a column window
    np.testing.assert_array_equal(
        gather(torch.as_tensor(table), torch.as_tensor(idx), 9, 3).numpy(),
        np.asarray(ref)[:, 9:12])
    assert gather.launches == 0


@pytest.mark.parametrize("bwd_cols", [None, (15, 27)])
def test_gather_rows_backward_matches_pallas(bwd_cols):
    table, idx = _inputs(1, 6000)
    g = np.random.default_rng(2).normal(size=(6000, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda tab: pallas_onehot_fetch_t(
        jnp.asarray(idx), tab, True, "pallas", bwd_cols), jnp.asarray(table))
    ref, = vjp(jnp.asarray(g.T))
    tab = torch.tensor(table, requires_grad=True)
    row = gather_rows(tab, torch.as_tensor(idx), grad_cols=bwd_cols)
    np.testing.assert_array_equal(row.detach().numpy(), table[idx])
    row.backward(torch.as_tensor(g))
    ours = tab.grad.numpy()
    if bwd_cols is not None:
        assert not ours[:, :bwd_cols[0]].any()
        assert not np.asarray(ref)[:, :bwd_cols[0]].any()
    checks.rows_close(torch.as_tensor(ours).T, torch.as_tensor(
        np.array(ref)).T, checks.ROW_RTOL, f"d_table {bwd_cols}")


def test_gather_rows_window_backward():
    """A column window of the forward (the occluder normals, columns 9-12)
    scatters its cotangent into those columns of the whole table."""
    table, idx = _inputs(3, 2000)
    g = np.random.default_rng(4).normal(size=(2, 1000, 3)).astype(np.float32)
    tab = torch.tensor(table, requires_grad=True)
    n = gather_rows(tab, torch.as_tensor(idx).reshape(2, 1000), cols=(9, 12))
    assert n.shape == (2, 1000, 3)
    np.testing.assert_array_equal(n.detach().numpy(),
                                  table[idx, 9:12].reshape(2, 1000, 3))
    n.backward(torch.as_tensor(g))
    ref = np.zeros((T, C), np.float64)
    np.add.at(ref[:, 9:12], idx, g.reshape(-1, 3).astype(np.float64))
    checks.rows_close(tab.grad.T, torch.as_tensor(ref).T, checks.ROW_RTOL,
                      "windowed d_table")
    assert not tab.grad[:, :9].any() and not tab.grad[:, 12:].any()
