"""The port's propagation masks, point-in-polygon test and cluster
post-processing (``ops/masks``, ``ops/clusters``) against the JAX package's,
on the same numpy inputs.

Masks, polygon tests and the polygon filter are held equal.  The per-cluster
mean speeds are held to 1e-5 relative: the port sums each cluster in a fixed
tree (``ordered.segment_sum``, so that the card and the CPU agree bit for
bit), XLA's ``segment_sum`` in row order, and two orders of ~100 float32
additions differ by at most ~100 * 2^-24 of the sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import clusters as jclusters
from datmo_using_optical_flow_tpu.ops import masks as jmasks
from datmo_using_optical_flow_tpu_torch.ops import clusters, masks
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

GRID = (0.2, 0.25)
DT = 0.1


def _colliding_velocities(seed: int, h: int = 48, w: int = 64):
    """Velocity grids whose cells move by -2 .. +2 cells (some off the grid),
    so that many cells land on the same target and the write order decides."""
    rng = np.random.default_rng(seed)
    shift_i = rng.integers(-2, 3, (h, w))
    shift_j = rng.integers(-2, 3, (h, w))
    vx = ((shift_i + rng.uniform(0.05, 0.95, (h, w))) * GRID[0] / DT).astype(np.float32)
    vy = ((shift_j + rng.uniform(0.05, 0.95, (h, w))) * GRID[1] / DT).astype(np.float32)
    return vx, vy, shift_i, shift_j


def _targets(shift_i, shift_j):
    h, w = shift_i.shape
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return ii + shift_i, jj + shift_j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propagation_mask_matches_jax_with_collisions(seed):
    vx, vy, si, sj = _colliding_velocities(seed)
    i2, j2 = _targets(si, sj)
    h, w = vx.shape
    inside = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
    flat = (i2 * w + j2)[inside]
    assert len(flat) - len(np.unique(flat)) > 500  # collisions are forced
    for alpha in (0.5, 3.0):
        want = np.asarray(jmasks.propagation_mask(jnp.asarray(vx), jnp.asarray(vy), DT, GRID,
                                                  alpha))
        got = masks.propagation_mask(torch.from_numpy(vx), torch.from_numpy(vy), DT, GRID,
                                     alpha)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("seed", [0, 1])
def test_propagation_mask_with_acceleration_matches_jax(seed):
    vx, vy, _, _ = _colliding_velocities(seed)
    rng = np.random.default_rng(10 + seed)
    ax = rng.normal(scale=20.0, size=vx.shape).astype(np.float32)
    ay = rng.normal(scale=20.0, size=vx.shape).astype(np.float32)
    args = (DT, GRID, 1.0)
    want = np.asarray(jmasks.propagation_mask_with_acceleration(
        *(jnp.asarray(a) for a in (vx, vy, ax, ay)), *args))
    got = masks.propagation_mask_with_acceleration(
        *(torch.from_numpy(a) for a in (vx, vy, ax, ay)), *args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_scatter_last_writer_keeps_numpys_order():
    """The scatter against numpy's own fancy assignment, whose duplicates
    keep the last writer in row-major order (the reference's loop)."""
    vx, vy, si, sj = _colliding_velocities(3, 20, 24)
    i2, j2 = _targets(si, sj)
    h, w = vx.shape
    ok = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
    want_x, want_y = np.zeros_like(vx), np.zeros_like(vy)
    want_x[i2[ok], j2[ok]] = vx[ok]
    want_y[i2[ok], j2[ok]] = vy[ok]
    px, py = masks._scatter_last_writer(torch.from_numpy(vx), torch.from_numpy(vy),
                                        torch.from_numpy(i2.astype(np.int32)),
                                        torch.from_numpy(j2.astype(np.int32)))
    np.testing.assert_array_equal(px.numpy(), want_x)
    np.testing.assert_array_equal(py.numpy(), want_y)


# a concave (arrow-shaped) polygon in (col, row) coordinates
_ARROW = np.array([[2.0, 2.0], [12.0, 2.0], [12.0, 6.0], [7.0, 4.0], [7.0, 12.0],
                   [4.5, 9.5], [2.0, 12.0]], np.float32)


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_points_in_polygon_matches_jax(closed):
    poly = np.vstack([_ARROW, _ARROW[:1]]) if closed else _ARROW
    # a half-step lattice over the polygon's box: points on its edges, on
    # every vertex, inside the notch and outside
    g = np.arange(0.0, 14.01, 0.5, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts = np.vstack([pts, _ARROW, np.random.default_rng(4).uniform(0, 14, (500, 2))
                     .astype(np.float32)])
    want = np.asarray(jmasks.points_in_polygon(jnp.asarray(pts), jnp.asarray(poly)))
    got = masks.points_in_polygon(torch.from_numpy(pts), torch.from_numpy(poly))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)
    inside = got.numpy()
    assert inside[np.flatnonzero((pts == [3.0, 3.0]).all(1))[0]]       # in the body
    assert not inside[np.flatnonzero((pts == [10.0, 8.0]).all(1))[0]]  # in the notch


def _cluster_cells(seed: int, n: int = 800, k: int = 8, h: int = 40, w: int = 50):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, k, n).astype(np.int32)
    rows = rng.integers(0, h, n).astype(np.int32)
    cols = rng.integers(0, w, n).astype(np.int32)
    rows[:5] = -1  # padded slots (label -1 or not) read cell (0, 0)
    vx = rng.normal(scale=2.0, size=(h, w)).astype(np.float32)
    vy = rng.normal(scale=2.0, size=(h, w)).astype(np.float32)
    return labels, rows, cols, vx, vy


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_mean_speeds_matches_jax(seed):
    labels, rows, cols, vx, vy = _cluster_cells(seed)
    k = 10  # two more slots than clusters: they stay empty
    want_s, want_e = (np.asarray(a) for a in jclusters.cluster_mean_speeds(
        *(jnp.asarray(a) for a in (labels, rows, cols, vx, vy)), k))
    got_s, got_e = clusters.cluster_mean_speeds(
        *(torch.from_numpy(a) for a in (labels, rows, cols, vx, vy)), k)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    assert want_e[:8].all() and not want_e[8:].any()
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=0)


def test_filter_clusters_by_polygon_matches_jax():
    labels, rows, cols, vx, vy = _cluster_cells(2, h=14, w=14)
    want = [np.asarray(a) for a in jclusters.filter_clusters_by_polygon(
        *(jnp.asarray(a) for a in (labels, rows, cols, vx, vy, _ARROW)))]
    got = clusters.filter_clusters_by_polygon(
        *(torch.from_numpy(a) for a in (labels, rows, cols, vx, vy, _ARROW)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < want[-1].sum() < (labels >= 0).sum()
