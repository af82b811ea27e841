"""The JAX package's edge cases and property sweeps (``tests/test_edge_cases.py``,
``test_skip_semantics.py``, ``test_property_sweeps.py``), each held against
the JAX function on the same seeded numpy inputs, and against the oracle
(scipy, sklearn) where the JAX test uses one.

Cases the port's tests already hold are not repeated here: the compat
``process_multiple_frames`` run (``test_torch_compat.py``), GMFA's plots
(``test_torch_viz.py``) and a corrupt PCD mid-sequence
(``test_torch_process_files.py``).  Buffer donation (``donate=True``) is a
JAX feature the port has no counterpart of.

Tolerances: assignments, labels, masks and skip flags exact; ICP's
transformation within 1e-6 of the identity and of JAX's (a no-op and an exact
fit), RANSAC's plane within 1e-6 of JAX's (the same hypotheses, float32 sums
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa
from sklearn.cluster import DBSCAN

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JPipelineAConfig
from datmo_using_optical_flow_tpu.models.optical_flow_datmo import PipelineA as JPipelineA
from datmo_using_optical_flow_tpu.ops import dbscan as jdb
from datmo_using_optical_flow_tpu.ops import hungarian as jh
from datmo_using_optical_flow_tpu.ops import icp as jicp
from datmo_using_optical_flow_tpu.ops import ransac as jransac
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.ops import dbscan as tdb
from datmo_using_optical_flow_tpu_torch.ops import hungarian as th
from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from datmo_using_optical_flow_tpu_torch.ops import ransac as transac
from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------------ Hungarian

@pytest.mark.parametrize("seed", range(3))
def test_hungarian_large_matches_jax_and_scipy(seed):
    cost = np.random.default_rng(seed).uniform(0, 100, size=(64, 64)).astype(np.float32)
    got = th.solve_square(_t(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.solve_square(jnp.asarray(cost))))
    ri, ci = scipy_lsa(cost)
    assert abs(cost[np.arange(64), got].sum() - cost[ri, ci].sum()) < 1e-2
    assert len(set(got.tolist())) == 64


def test_hungarian_with_equal_costs():
    cost = np.ones((8, 8), np.float32)
    got = th.solve_square(_t(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.solve_square(jnp.asarray(cost))))
    assert len(set(got.tolist())) == 8  # any permutation is optimal


@pytest.mark.parametrize("seed", range(20))
def test_hungarian_random_rectangular(seed):
    rng = np.random.default_rng(seed)
    r, c = int(rng.integers(1, 24)), int(rng.integers(1, 24))
    cost = rng.uniform(0, 50, size=(r, c)).astype(np.float32)
    col4row, valid = (x.numpy() for x in th.linear_sum_assignment(_t(cost)))
    want = jh.linear_sum_assignment(jnp.asarray(cost))
    np.testing.assert_array_equal(col4row, np.asarray(want[0]))
    np.testing.assert_array_equal(valid, np.asarray(want[1]))
    ri, ci = scipy_lsa(cost)
    assert int(valid.sum()) == min(r, c)
    got = sum(cost[i, col4row[i]] for i in range(r) if valid[i])
    assert abs(got - cost[ri, ci].sum()) < 1e-3, (seed, r, c)
    cols = [int(col4row[i]) for i in range(r) if valid[i]]
    assert len(set(cols)) == len(cols)


# ------------------------------------------------------------------ ICP

def _icp_both(src, dst, **kw):
    m = np.ones(len(src), bool)
    want = jicp.registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                                 jnp.asarray(m), **kw)
    got = ticp.registration_icp(_t(src), _t(m), _t(dst), _t(m), **kw)
    return got, want


def test_icp_no_correspondences_returns_identity():
    src = np.random.default_rng(0).normal(size=(512, 3)).astype(np.float32)
    got, want = _icp_both(src, src + 100.0, threshold=0.01, max_iterations=10)
    np.testing.assert_allclose(got.transformation.numpy(), np.eye(4), atol=1e-6)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-6)
    assert float(got.fitness) == float(want.fitness) == 0.0
    assert int(got.iterations) == int(want.iterations)


def test_icp_identical_clouds():
    pts = np.random.default_rng(1).normal(size=(512, 3)).astype(np.float32)
    got, want = _icp_both(pts, pts, threshold=0.5)
    np.testing.assert_allclose(got.transformation.numpy(), np.eye(4), atol=1e-4)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-6)
    assert float(got.fitness) == float(want.fitness) and float(got.fitness) > 0.999
    assert int(got.iterations) == int(want.iterations)


# ------------------------------------------------------------------ RANSAC

def test_ransac_few_points():
    """A plane through a handful of points among padding: no crash, the same
    plane and inliers as JAX's from the same key."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0.5, 0.01],
                    [2, 2, 5.0]], np.float32)  # 5 planar + 1 outlier
    pad = np.full((512, 3), 1e9, np.float32)
    pad[:6] = pts
    m = np.zeros(512, bool)
    m[:6] = True
    want_plane, want_inl = jransac.segment_plane(jnp.asarray(pad), jnp.asarray(m),
                                                 jax.random.PRNGKey(0), 0.05, 3, 500)
    plane, inl = transac.segment_plane(_t(pad), _t(m), prng.PRNGKey(0), 0.05, 3, 500)
    plane, inl = plane.numpy(), inl.numpy()
    assert abs(plane[2]) > 0.99
    assert inl[:5].all() and not inl[5]
    np.testing.assert_array_equal(inl, np.asarray(want_inl))
    np.testing.assert_allclose(plane, np.asarray(want_plane), atol=1e-6)


# ------------------------------------------------------------------ DBSCAN

def test_dbscan_single_point():
    feats = np.full((512, 3), 3e18, np.float32)
    feats[0] = [0, 0, 0]
    valid = np.zeros(512, bool)
    valid[0] = True
    for min_samples, label, is_core in ((1, 0, True), (2, -1, False)):  # 1: self-core
        labels, core = (x.numpy() for x in tdb.dbscan(_t(feats), _t(valid), 1.0, min_samples))
        want = jdb.dbscan(jnp.asarray(feats), jnp.asarray(valid), 1.0, min_samples)
        np.testing.assert_array_equal(labels, np.asarray(want[0]))
        np.testing.assert_array_equal(core, np.asarray(want[1]))
        assert int(labels[0]) == label and bool(core[0]) == is_core


@pytest.mark.parametrize("seed", range(8))
def test_dbscan_random_clouds(seed):
    rng = np.random.default_rng(100 + seed)
    n_clusters = int(rng.integers(1, 5))
    centers = rng.uniform(-20, 20, size=(n_clusters, 2))
    parts = [c + rng.normal(scale=rng.uniform(0.1, 0.5), size=(int(rng.integers(20, 80)), 2))
             for c in centers]
    parts.append(rng.uniform(-25, 25, size=(int(rng.integers(5, 30)), 2)))
    pts = np.concatenate(parts).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    eps = float(rng.uniform(0.4, 1.5))
    ms = int(rng.integers(2, 8))
    sk = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_

    cap = int(np.ceil(len(pts) / 512) * 512)
    feats = np.full((cap, 2), 3e18, np.float32)
    feats[:len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[:len(pts)] = True
    labels, core = (x.numpy() for x in tdb.dbscan(_t(feats), _t(valid), eps, ms))
    want = jdb.dbscan(jnp.asarray(feats), jnp.asarray(valid), eps, ms)
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    np.testing.assert_array_equal(core, np.asarray(want[1]))

    # sklearn: the same noise, the same partition of the core points
    ours, core = labels[:len(pts)], core[:len(pts)]
    np.testing.assert_array_equal(ours == -1, sk == -1)
    mapping = {}
    for a, b in zip(ours[core], sk[core]):
        assert mapping.setdefault(int(a), int(b)) == int(b), seed
    assert len(set(mapping.values())) == len(mapping)


# ------------------------------------------------------------------ skip semantics

def _cfgs():
    caps = dict(max_raw_points=1024, max_roi_points=256, max_cells=256, max_clusters=4,
                max_tracks=8)
    return (PipelineAConfig(capacities=CapacityConfig(**caps)),
            JPipelineAConfig(capacities=JCapacity(**caps)))


def test_zero_bev_pair_is_noop():
    """An empty BEV in a pair is a masked no-op (the reference's None-BEV
    skip): the carry comes out as it went in, and the stream goes on; the
    skip flags equal JAX's at each step."""
    cfg, jcfg = _cfgs()
    pipe, jpipe = PipelineA(cfg, device="cpu", fast_warp=False), JPipelineA(jcfg,
                                                                           fast_warp=False)
    h, w = cfg.grid_shape
    good = np.random.default_rng(0).integers(1, 255, size=(h, w)).astype(np.uint8)
    zero = np.zeros((h, w), np.uint8)
    carry, jcarry = pipe.init_carry(), jpipe.init_carry()
    for a, b, skip in ((good, good, False), (good, zero, True), (good, good, False)):
        before = carry.prev_vx.clone(), carry.table.alive.clone()
        carry, out = pipe.step(_t(a), _t(b), carry)
        jcarry, jout = jpipe.step(jnp.asarray(a), jnp.asarray(b), jcarry)
        assert bool(out.skip) == bool(jout.skip) == skip
        if skip:
            assert torch.equal(carry.prev_vx, before[0])
            assert torch.equal(carry.table.alive, before[1])


def test_empty_roi_preprocess_yields_zero_bev():
    cfg, jcfg = _cfgs()
    pts = np.full((64, 3), 500.0, np.float32)  # far outside the ROI
    mask = np.ones(64, bool)
    bev = PipelineA(cfg, device="cpu").preprocess(_t(pts), _t(mask), prng.PRNGKey(0))
    want = JPipelineA(jcfg).preprocess(jnp.asarray(pts), jnp.asarray(mask),
                                       jax.random.PRNGKey(0))
    assert int(bev.sum()) == 0
    np.testing.assert_array_equal(bev.numpy(), np.asarray(want))
