"""The port's BEV rasterisation against the JAX package's, bit for bit: the
cell statistics and the uint8 grid, with points below the grid's origin
(truncating bins), negative mean heights (the uint8 wrap), masked and
out-of-grid points, and an empty grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import bev as jb
from datmo_using_optical_flow_tpu_torch.ops import bev as tb
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ARGS = ((80, 80), (-8.0, 8.0), (-8.0, 8.0), (0.2, 0.2))


def _cloud(seed: int, z_mean: float):
    rng = np.random.default_rng(seed)
    n = 4000
    pts = np.stack([rng.uniform(-9, 9, n), rng.uniform(-9, 9, n),
                    rng.normal(z_mean, 1.0, n)], axis=1).astype(np.float32)
    pts[:2000, :2] = rng.normal(0.0, 0.6, (2000, 2))      # dense cells
    pts[2000:2100, 0] = rng.uniform(-8.2, -8.0, 100)      # in (x0 - w, x0): bin 0
    pts[2100:2200, 1] = rng.uniform(-8.2, -8.0, 100)
    mask = rng.uniform(size=n) < 0.9
    return pts, mask


@pytest.mark.parametrize("seed,z_mean", [(0, 0.5), (1, -0.3), (2, -1.5), (3, 2.0)])
def test_bev_bit_equal_to_jax(seed, z_mean):
    pts, mask = _cloud(seed, z_mean)
    want = [np.asarray(x) for x in jb.bev_cell_stats(jnp.asarray(pts), jnp.asarray(mask), *ARGS)]
    got = [x.numpy() for x in tb.bev_cell_stats(torch.as_tensor(pts), torch.as_tensor(mask),
                                                *ARGS)]
    for g, w, name in zip(got, want, ("count", "mean", "std")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    want = np.asarray(jb.compute_bev_grid(jnp.asarray(pts), jnp.asarray(mask), *ARGS))
    grid = tb.compute_bev_grid(torch.as_tensor(pts), torch.as_tensor(mask), *ARGS)
    assert grid.dtype == torch.uint8 and tuple(grid.shape) == (80, 80)
    np.testing.assert_array_equal(grid.numpy(), want)
    assert (want > 0).sum() > 100
    if z_mean < 0:  # some cells are negative: they wrap modulo 256, as numpy's astype does
        cnt, mean, std = got
        assert ((cnt > 0) & (0.5 * mean + 0.5 * std < 0)).any()


def test_bev_empty_grid():
    pts = np.full((64, 3), 1e9, np.float32)
    for mask in (np.zeros(64, bool), np.ones(64, bool)):  # nothing valid / nothing in the grid
        want = np.asarray(jb.compute_bev_grid(jnp.asarray(pts), jnp.asarray(mask), *ARGS))
        got = tb.compute_bev_grid(torch.as_tensor(pts), torch.as_tensor(mask), *ARGS).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 0


def test_bev_point_order_changes_only_rounding():
    """Sums run in point order within each cell: reversing the points keeps
    the counts and may change only float rounding, never the cells filled."""
    pts, mask = _cloud(4, 0.2)
    a = tb.bev_cell_stats(torch.as_tensor(pts), torch.as_tensor(mask), *ARGS)
    b = tb.bev_cell_stats(torch.as_tensor(pts[::-1].copy()), torch.as_tensor(mask[::-1].copy()),
                          *ARGS)
    assert torch.equal(a[0], b[0])
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=1e-5)
