"""The port's GMFA ops (Hungarian, SOM, cluster features, DBSCAN's tiled
branch, point ops) against the JAX package on the same numpy inputs.

Tolerances: assignments, labels and masks exact; SOM within 1e-6 (the
log-step scan groups the float32 additions differently from JAX's
associative scan); cluster features within 1e-5 (float32 segment sums in
another order, through a 3x3 eigensolver).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.models import gmfa as jgmfa
from datmo_using_optical_flow_tpu.ops import dbscan as jdb
from datmo_using_optical_flow_tpu.ops import hungarian as jh
from datmo_using_optical_flow_tpu.ops import points as jpts
from datmo_using_optical_flow_tpu.ops import som as jsom
from datmo_using_optical_flow_tpu_torch.models import gmfa as tgmfa
from datmo_using_optical_flow_tpu_torch.ops import dbscan as tdb
from datmo_using_optical_flow_tpu_torch.ops import hungarian as th
from datmo_using_optical_flow_tpu_torch.ops import points as tpts
from datmo_using_optical_flow_tpu_torch.ops import som as tsom
from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _masks(rng, r, c, nr, nc):
    rm = np.zeros(r, bool)
    rm[rng.choice(r, nr, replace=False)] = True
    cm = np.zeros(c, bool)
    cm[rng.choice(c, nc, replace=False)] = True
    return rm, cm


# (rows, cols, valid rows, valid cols): square, rectangular both ways,
# masked, and the compacted tier (r, c > 16 with <= 16 valid each) and its
# neighbour just above the tier's capacity
@pytest.mark.parametrize("r,c,nr,nc", [(8, 8, None, None), (5, 9, None, None),
                                       (9, 5, None, None), (12, 10, 7, 6),
                                       (64, 32, 10, 12), (64, 32, 17, 9), (40, 24, 16, 16)])
def test_hungarian_matches_jax(r, c, nr, nc):
    rng = np.random.default_rng(r * 100 + c)
    # quantised costs make ties between equal-cost optima likely
    cost = rng.integers(0, 6, size=(r, c)).astype(np.float32) * 0.5
    if nr is None:
        want = jh.linear_sum_assignment(jnp.asarray(cost))
        got = th.linear_sum_assignment(torch.as_tensor(cost))
        if r == c:
            np.testing.assert_array_equal(th.solve_square(torch.as_tensor(cost)).numpy(),
                                          np.asarray(jh.solve_square(jnp.asarray(cost))))
    else:
        rm, cm = _masks(rng, r, c, nr, nc)
        want = jh.linear_sum_assignment(jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm))
        got = th.linear_sum_assignment(torch.as_tensor(cost), torch.as_tensor(rm),
                                       torch.as_tensor(cm))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("seed", [0, 1])
def test_update_som_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g, res, n = 50, (0.2, 0.2), 2048
    # many hits per cell with interleaved static/moving evidence: the
    # sequential clamp is order-dependent
    pts = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    pts[1900:] = 1e9
    residuals = rng.choice([0.05, 0.4, 1.0], size=n).astype(np.float32)
    mask = np.arange(n) < 1900
    som0 = rng.uniform(0.05, 0.95, size=(g, g)).astype(np.float32)
    args = (som0, pts, mask, residuals)
    want = jsom.update_som(*map(jnp.asarray, args), 0.2, 0.6, res)
    got = tsom.update_som(*map(torch.as_tensor, args), 0.2, 0.6, res)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_cluster_features_matches_jax():
    rng = np.random.default_rng(3)
    n, k = 1000, 6
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2 + 5
    labels = rng.integers(-1, 4, size=n).astype(np.int32)
    labels[7] = 4  # a one-point cluster; cluster 5 is empty
    labels[900:] = -1
    want = jgmfa._cluster_features(jnp.asarray(pts), jnp.asarray(labels), k)
    got = tgmfa._cluster_features(torch.as_tensor(pts), torch.as_tensor(labels), k)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def test_dbscan_tiled_branch_matches_jax(monkeypatch):
    """1500 rows pad to 1536 > 1024: both packages take their tiled branch."""
    rng = np.random.default_rng(9)
    centres = ((0, 0, 0), (6, 0, 1), (0, 7, 0), (3, 3, 5))
    pts = np.concatenate([rng.normal(c, 0.9, size=(360, 3)) for c in centres]
                         + [rng.uniform(-10, 15, size=(60, 3))]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[::97] = False
    monkeypatch.setattr(jdb, "_FULL_MATRIX_MAX", 1024)
    monkeypatch.setattr(tdb, "_FULL_MATRIX_MAX", 1024)
    # the traced function: the jitted one may hold a trace of the other branch
    jfn = getattr(jdb.dbscan, "__wrapped__", jdb.dbscan)
    for eps, min_samples in ((1.0, 12), (1.6, 40)):
        want = jfn(jnp.asarray(pts), jnp.asarray(valid), eps, min_samples)
        got = tdb.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), eps, min_samples)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[0].max()) >= 3  # several clusters, noise and border points
        assert (got[0].numpy() == -1).sum() > 60


def test_point_ops_match_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-25, 25, size=(500, 3)).astype(np.float32)
    pts[450:] = 1e9
    mask = np.arange(500) < 450
    bounds = (-20.0, 20.0, -20.0, 20.0, -3.0, 3.0)
    np.testing.assert_array_equal(tpts.flip_x(torch.as_tensor(pts)).numpy(),
                                  np.asarray(jpts.flip_x(jnp.asarray(pts))))
    np.testing.assert_array_equal(tpts.roi_mask(torch.as_tensor(pts), bounds).numpy(),
                                  np.asarray(jpts.roi_mask(jnp.asarray(pts), bounds)))
    np.testing.assert_array_equal(
        tpts.roi_mask_2d(torch.as_tensor(pts), bounds[:4]).numpy(),
        np.asarray(jpts.roi_mask_2d(jnp.asarray(pts), bounds[:4])))
    # the jitter from a key, against the compiled densify that JAX's preprocess runs
    jitted = jax.jit(partial(jpts.densify, expansion_factor=10, noise_std=0.01))
    want = jitted(jnp.asarray(pts), jnp.asarray(mask), jax.random.PRNGKey(4))
    got = tpts.densify(torch.as_tensor(pts), torch.as_tensor(mask), prng.PRNGKey(4), 10)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_ordered_helpers():
    """``utils/ordered.py``: the fixed-order sums and products equal torch's
    own within float32 rounding, and the tree is the one its docstring names."""
    from datmo_using_optical_flow_tpu_torch.utils import ordered

    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(1000, 5)).astype(np.float32))
    np.testing.assert_allclose(ordered.tree_sum(x).numpy(), x.sum(0).numpy(), atol=1e-4)
    # padded to 8 and halved: (1 + e) + ... rounds each e away one at a time,
    # the tree adds 1 + (e + e) once: 1 + 2^-23
    v = torch.tensor([1.0] + [2.0 ** -24] * 4)
    assert float(ordered.tree_sum(v)) == 1.0 + 2.0 ** -23 != float(np.cumsum(v.numpy())[-1])
    seg = torch.as_tensor(rng.integers(-1, 4, size=1000))
    want = torch.zeros(4, 5).index_add_(0, seg.clamp(min=0), torch.where(seg[:, None] >= 0, x, 0))
    np.testing.assert_allclose(ordered.segment_sum(x, seg, 4).numpy(), want.numpy(), atol=1e-4)
    a = torch.as_tensor(rng.normal(size=(6, 4, 3)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(3, 2)).astype(np.float32))
    np.testing.assert_allclose(ordered.matmul_terms(a, b).numpy(), (a @ b).numpy(), atol=1e-5)
    m = torch.as_tensor(rng.normal(size=(7, 2, 2)).astype(np.float32)) + 3 * torch.eye(2)
    np.testing.assert_allclose(ordered.inv2(m).numpy(), torch.linalg.inv(m).numpy(), atol=1e-5)
