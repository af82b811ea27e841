"""The port's DATMO tail (masks, compaction, DBSCAN, tracking) against the JAX
package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.models import optical_flow_datmo as jpipe
from datmo_using_optical_flow_tpu.models import tracker_a as jtrk
from datmo_using_optical_flow_tpu.ops import dbscan as jdb
from datmo_using_optical_flow_tpu.ops import masks as jmasks
from datmo_using_optical_flow_tpu.utils import padding as jpad
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models import optical_flow_datmo as tpipe
from datmo_using_optical_flow_tpu_torch.models import tracker_a as ttrk
from datmo_using_optical_flow_tpu_torch.ops import dbscan as tdb
from datmo_using_optical_flow_tpu_torch.ops import masks as tmasks
from datmo_using_optical_flow_tpu_torch.utils import padding as tpad
from datmo_using_optical_flow_tpu_torch.utils.state import carry_from_numpy, carry_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_tree(got, want, atol):
    """Leaf-by-leaf: integer and bool leaves exact, float leaves within atol."""
    got, want = jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, equal_nan=True)
        else:
            np.testing.assert_array_equal(g, w)


def _velocity_grid(h, w, seed):
    """Blocks of constant flow (px/frame) on a still background."""
    rng = np.random.default_rng(seed)
    flow = np.zeros((h, w, 2), np.float32)
    for _ in range(4):
        r, c = rng.integers(0, h - 12), rng.integers(0, w - 12)
        flow[r:r + rng.integers(6, 12), c:c + rng.integers(6, 12)] = rng.uniform(-4, 4, 2)
    flow += rng.normal(scale=0.02, size=flow.shape).astype(np.float32)
    return flow


def test_masks_bit_equal():
    flow = _velocity_grid(48, 64, 0)
    want = jmasks.velocity_from_flow(jnp.asarray(flow), (0.0, 4.8), (0.0, 6.4))
    got = tmasks.velocity_from_flow(torch.as_tensor(flow), (0.0, 4.8), (0.0, 6.4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for axis in (0, 1):
        np.testing.assert_array_equal(_np(tmasks.gradient(got[0], axis)),
                                      np.asarray(jmasks.gradient(want[0], axis)))
    cm = tmasks.continuity_mask(got[0], got[1], 0.2)
    assert cm.dtype == torch.int32
    np.testing.assert_array_equal(_np(cm), np.asarray(jmasks.continuity_mask(want[0], want[1], 0.2)))


def test_argmin_with_nan_matches_jax():
    """A one-cell cluster's NaN eigenvalues reach argmin(dist) in association."""
    for vals in ([np.inf, np.nan, 0.2, np.nan], [0.3, np.inf, 0.1], [np.nan, np.nan],
                 [np.inf, np.inf, np.nan], [np.inf, np.inf]):
        a = np.asarray(vals, np.float32)
        assert int(torch.argmin(torch.as_tensor(a))) == int(jnp.argmin(jnp.asarray(a)))


# sizes reach the JAX package's scatter, top_k and bitpacked branches
@pytest.mark.parametrize("n,capacity,density", [(1000, 300, 0.2), (1000, 300, 0.5),
                                                (40000, 1000, 0.01), (1 << 20, 4096, 0.003)])
def test_compact_masked_exact(n, capacity, density):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    mask = rng.random(n) < density
    want = jpad.compact_masked(jnp.asarray(x), jnp.asarray(mask), capacity, fill_value=3e18)
    got = tpad.compact_masked(torch.as_tensor(x), torch.as_tensor(mask), capacity,
                              fill_value=3e18)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("seed,max_cells", [(0, 512), (1, 512), (2, 64)])
def test_dbscan_velocity_grid_exact(seed, max_cells):
    """Labels, rows and cols exact, including a truncated cell set (64)."""
    h, w = 48, 64
    flow = _velocity_grid(h, w, seed)
    vx, vy = flow[..., 0] * 0.1, flow[..., 1] * 0.1
    valid = np.hypot(vx, vy) > 0.1
    rng = np.random.default_rng(seed)
    valid |= rng.random((h, w)) < 0.02  # isolated noise cells
    want = jdb.dbscan_velocity_grid(jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(valid), 5.0,
                                    3, (h, w), max_cells)
    got = tdb.dbscan_velocity_grid(torch.as_tensor(vx), torch.as_tensor(vy),
                                   torch.as_tensor(valid), 5.0, 3, (h, w), max_cells)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(e))
    assert int(got[0].max()) >= 1  # several clusters


def test_dbscan_blobs_and_shared_border_points_exact():
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.normal(c, 0.6, size=(40, 2)) for c in ((0, 0), (4, 0), (0, 9))])
    pts = np.concatenate([pts, [[2.0, 0.0], [20.0, 20.0]]]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[5] = False
    jl, jc = jdb.dbscan(jnp.asarray(pts), jnp.asarray(valid), 1.2, 4)
    tl, tc = tdb.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), 1.2, 4)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))


def test_extract_clusters_with_one_cell_cluster():
    h, w, k = 30, 40, 5
    rng = np.random.default_rng(2)
    n = 64
    rows = rng.integers(0, h, n).astype(np.int32)
    cols = rng.integers(0, w, n).astype(np.int32)
    labels = rng.integers(-1, 3, n).astype(np.int32)
    labels[10] = 3  # the only cell of cluster 3: NaN eigenvalues
    rows[50:], cols[50:], labels[50:] = -1, -1, -1  # padding
    vx, vy = (rng.normal(size=(h, w)).astype(np.float32) for _ in range(2))
    args = (labels, rows, cols, vx, vy)
    want = jtrk.extract_clusters(*map(jnp.asarray, args), k)
    got = ttrk.extract_clusters(*map(torch.as_tensor, args), k)
    _assert_tree(got, want, atol=1e-5)
    assert np.isnan(_np(got.eigenvalues)[3]).all() and not _np(got.exists)[4]


def _cluster_frames(n_frames, k, seed):
    """Cluster slots for a run of frames: drifting objects with small
    eigenvalues (so they match their tracks), objects that vanish and return,
    two clusters claiming one track, and a one-cell cluster (NaN eigenvalues)."""
    rng = np.random.default_rng(seed)
    pos = np.array([[5.0, 5.0], [20.0, 8.0], [12.0, 30.0]])
    frames = []
    for t in range(n_frames):
        exists = np.zeros(k, bool)
        cen = np.zeros((k, 2), np.float32)
        eig = np.zeros((k, 2), np.float32)
        vel = rng.normal(scale=0.2, size=(k, 2)).astype(np.float32)
        pos = pos + rng.normal(scale=0.05, size=pos.shape)
        for j in range(3):
            # object 0 alone first: its track is confirmed, deleted, and its id
            # reborn into the ghost slot; then objects vanish every fifth frame
            if (j == 0 and t < 6) or (t >= 6 and (t + j) % 5 != 4):
                exists[j] = True
                cen[j] = pos[j]
                eig[j] = rng.uniform(0.0, 0.2, 2)
        if t >= 6 and t % 3 == 1:  # a second claimant of object 0's track
            exists[3], cen[3], eig[3] = True, pos[0] + 0.1, (0.05, 0.01)
        if t >= 6 and t % 4 == 2:  # a one-cell cluster
            exists[4], cen[4], eig[4] = True, (3.0, 33.0), (np.nan, np.nan)
        meas = np.concatenate([cen, vel], axis=1).astype(np.float32)
        frames.append((exists, cen, meas, eig))
    return frames


def test_tracking_matches_jax_over_a_run():
    """associate_and_update + lifecycle frame after frame, each side carrying
    its own table: states atol 1e-5, ids, alive flags, lifetimes and
    confirmations exact.  Short lifecycle constants make confirmed tracks die
    and their ids come back (ghost slots inheriting lifetimes)."""
    cap, k = 6, 5
    life = dict(m1=1, n1=2, m2=1, n2=3)
    jt, tt = jtrk.new_track_table(cap), ttrk.new_track_table(cap)
    seen = {"matched": 0, "inherited": 0, "deleted": 0}
    for exists, cen, meas, eig in _cluster_frames(24, k, seed=4):
        jc = jtrk.Clusters(*map(jnp.asarray, (exists, cen, meas, eig)))
        tc = ttrk.Clusters(*map(torch.as_tensor, (exists, cen, meas, eig)))
        before = jax.device_get(jt)
        jsnap = jtrk.associate_and_update(jt, jc, 1.0, 0.1, 0.05, 0.5)
        tsnap = ttrk.associate_and_update(tt, tc, 1.0, 0.1, 0.05, 0.5)
        _assert_tree(tsnap, jsnap, atol=1e-5)
        jt = jtrk.lifecycle(jsnap, **life)
        tt = ttrk.lifecycle(tsnap, **life)
        _assert_tree(tt, jt, atol=1e-5)

        snap = jax.device_get(jsnap)
        seen["matched"] += int(np.sum(before.alive & snap.alive & (before.tid == snap.tid)))
        seen["inherited"] += int(np.sum(~before.alive & snap.alive & (before.lifetime > 0)
                                        & (snap.lifetime > 0)))
        seen["deleted"] += int(np.sum(snap.alive & ~np.asarray(jt.alive)))
    assert all(v > 0 for v in seen.values()), seen


def _tail_cfgs(h, w):
    kw = dict(x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1))
    return (JConfig(capacities=JCapacity(max_cells=256, max_clusters=8, max_tracks=8), **kw),
            PipelineAConfig(capacities=CapacityConfig(max_cells=256, max_clusters=8,
                                                      max_tracks=8), **kw))


def test_datmo_tail_matches_jax():
    """The whole tail on the same flow, three pairs with carried state (the
    second pair invalid, so it must leave the carry untouched): integer outputs
    exact, floats atol 1e-5."""
    h, w = 48, 64
    jcfg, tcfg = _tail_cfgs(h, w)
    jcarry = jpipe.PipelineA(jcfg).init_carry()
    tcarry = carry_from_numpy(jax.device_get(jcarry), "cpu")
    for i, valid in enumerate((True, False, True)):
        flow = _velocity_grid(h, w, 10 + i)
        jcarry, jout = jpipe._datmo_tail(jnp.asarray(flow), jnp.asarray(valid), jcarry, jcfg)
        tcarry, tout = tpipe._datmo_tail(torch.as_tensor(flow), torch.as_tensor(valid),
                                         tcarry, tcfg)
        _assert_tree(tout, jax.device_get(jout), atol=1e-5)
        _assert_tree(carry_to_numpy(tcarry), jax.device_get(jcarry), atol=1e-5)
        assert bool(tout.skip) is not valid
        assert int(tout.cell_count) > 0
