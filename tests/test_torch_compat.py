"""The port's reference-API surface (``compat``) against the JAX package's
``compat``, on the inputs of ``tests/test_compat_and_config.py`` and
``tests/test_edge_cases.py``, every function with ``device="cpu"``.

Tolerances: masks, BEVs, clusters, the polygon filter and the tracking
oracle exact.  The flow (and the velocities and curl from it) within 1e-4
px: the port's exact warp on every level (K2's and K3's plain versions)
against JAX's XLA path, the limit of ``test_torch_farneback``'s exact-warp
test; the velocities are flow times a pixel size below 1, the curl a
difference of two central differences of them (2e-4).  The tracks of
``process_multiple_frames`` within 5e-3, as ``test_torch_process_files``
holds pipeline A's runner (JAX's compat runs its XLA flow, the port its
kernels' plain versions).  Also ``seed=`` of GMFA's ``process_files`` (frame
keys and expanded clouds equal to JAX's) and the imports: ``compat`` and
``io.viz`` import without pyyaml, matplotlib, cv2 or sklearn.
"""

import inspect
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu import compat as jcompat
from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JPipelineAConfig
from datmo_using_optical_flow_tpu.io import viz as jviz
from datmo_using_optical_flow_tpu.oracle import reference_a as jref
from datmo_using_optical_flow_tpu_torch import compat
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.io import viz as tviz
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.oracle import reference_a as tref
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (SyntheticScene,
                                                              write_synthetic_sequence)
from datmo_using_optical_flow_tpu_torch.utils import prng
from test_torch_gmfa_process_files import _CAPS as _GMFA_CAPS
from test_torch_gmfa_process_files import _cfg as _gmfa_cfg
from test_torch_gmfa_process_files import _jax_pipe as _jax_gmfa
from test_torch_gmfa_process_files import seq as gmfa_seq  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
FLOW_ATOL = 1e-4


def test_roi_bev_and_continuity_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-15, 15, size=(2000, 3))
    roi = (-10, 10, -10, 10, -3, 1)
    np.testing.assert_array_equal(compat.filter_points_in_roi(pts, roi, **CPU),
                                  jcompat.filter_points_in_roi(pts, roi))
    args = ((0.2, 0.2), (-20, 20), (-20, 20))
    bev = compat.compute_bev_grid(pts, *args, h_max=2.0, **CPU)
    assert bev.dtype == np.uint8 and bev.any()
    np.testing.assert_array_equal(bev, jcompat.compute_bev_grid(pts, *args, h_max=2.0))
    vx = rng.normal(scale=0.3, size=(40, 40)).astype(np.float32)
    vy = rng.normal(scale=0.3, size=(40, 40)).astype(np.float32)
    np.testing.assert_array_equal(compat.continuity_mask(vx, vy, 0.2, **CPU),
                                  jcompat.continuity_mask(vx, vy, 0.2))
    rep = compat.increase_point_density(pts[:10], 3, 0.05, seed=4)
    np.testing.assert_array_equal(rep, jcompat.increase_point_density(pts[:10], 3, 0.05, seed=4))


def _shifted_pair(h: int, w: int, seed: int = 1, shift=(1.0, 0.0)):
    rng = np.random.default_rng(seed)
    bev1 = cv2.GaussianBlur(rng.uniform(0, 255, (h, w)).astype(np.float32), (0, 0), 2)
    bev2 = cv2.warpAffine(bev1, np.float32([[1, 0, shift[0]], [0, 1, shift[1]]]), (w, h))
    return bev1, bev2


@pytest.fixture(scope="module")
def flow_48():
    """The JAX test's 48x48 pair (one pyramid level, below K3's 128x256)."""
    bev1, bev2 = _shifted_pair(48, 48)
    return bev1, bev2, jcompat.compute_velocity_vectors(bev1, bev2, (-20, 20), (-20, 20))


@pytest.mark.parametrize("shape", [(48, 48), (128, 256)], ids=["48x48", "128x256"])
def test_compute_velocity_vectors_matches_jax(shape, flow_48):
    """48x48 runs K2's plain version, 128x256 K3's (a level of at least
    128x256), both with the exact warp, against JAX's XLA path and cv2."""
    if shape == (48, 48):
        bev1, bev2, want = flow_48
    else:
        bev1, bev2 = _shifted_pair(*shape, seed=2, shift=(1.7, -0.6))
        want = jcompat.compute_velocity_vectors(bev1, bev2, (-20, 20), (-20, 20))
    got = compat.compute_velocity_vectors(bev1, bev2, (-20, 20), (-20, 20), **CPU)
    for g, w, atol in zip(got, want, (FLOW_ATOL, FLOW_ATOL, 2 * FLOW_ATOL)):
        assert g.dtype == np.float32 and g.shape == shape
        np.testing.assert_allclose(g, w, atol=atol)
    flow = cv2.calcOpticalFlowFarneback(bev1, bev2, None, 0.3, 5, 15, 5, 5, 5, 0)
    np.testing.assert_allclose(got[0], flow[..., 0] * (40 / shape[1]), atol=1e-3)


def test_masks_dbscan_and_roi_filter_match_jax(flow_48):
    """The masks, DBSCAN and the road filter on JAX's velocity grids."""
    _, _, (vx, vy, _) = flow_48
    np.testing.assert_array_equal(compat.propagation_mask(vx, vy, 0.1, (0.2, 0.2), 0.5, **CPU),
                                  jcompat.propagation_mask(vx, vy, 0.1, (0.2, 0.2), 0.5))
    ax, ay = np.gradient(vx)[0] * 10, np.gradient(vy)[1] * 10
    np.testing.assert_array_equal(
        compat.propagation_mask_with_acceleration(vx, vy, ax, ay, 0.1, (0.2, 0.2), 0.5, **CPU),
        jcompat.propagation_mask_with_acceleration(vx, vy, ax, ay, 0.1, (0.2, 0.2), 0.5))
    valid = np.hypot(vx, vy) > 0.1
    labels, idx = compat.dbscan_clustering(vx, vy, valid, eps=5.0, min_samples=3, **CPU)
    jlabels, jidx = jcompat.dbscan_clustering(vx, vy, valid, eps=5.0, min_samples=3)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(idx, jidx)
    assert len(labels) == int(valid.sum()) and (labels >= 0).any()
    assert compat.calculate_dbscan_cluster_velocities(labels, idx, vx, vy) == \
        jcompat.calculate_dbscan_cluster_velocities(jlabels, jidx, vx, vy)
    road = np.array([[0, 0], [40, 5], [47, 30], [20, 47], [10, 25], [0, 30]], np.float32)
    got = compat.filter_clusters_by_roi(labels, idx, (vx, vy), valid, road, **CPU)
    want = jcompat.filter_clusters_by_roi(jlabels, jidx, (vx, vy), valid, road)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < len(want[0]) < int((labels >= 0).sum())


def test_tracking_oracle_matches_jax():
    """``extract_cluster_data``, ``EKF``, ``track_clusters`` and
    ``manage_tracks`` over three frames of drifting clusters, on both
    packages' oracles: the same dicts and states."""
    assert compat.EKF is tref.RefEKF and compat.track_clusters is tref.track_clusters
    rng = np.random.default_rng(3)
    sides = {}
    for name, ref in (("port", tref), ("jax", jref)):
        tracks, lifetimes, confirmed, log = {}, {}, set(), []
        for frame in range(3):
            idx = np.concatenate([rng.normal(c, 1.5, (30, 2)) for c in ((10 + frame, 12),
                                                                      (30, 25 - frame))])
            idx = np.clip(np.round(idx), 0, 47).astype(np.int64)
            labels = np.repeat([0, 1], 30)
            labels[::7] = -1
            vx = rng.normal(size=(48, 48))
            vy = rng.normal(size=(48, 48))
            clusters = ref.extract_cluster_data(labels, idx, vx, vy)
            tracks = ref.track_clusters(tracks, clusters, 0.1, np.eye(4) * 0.1, np.eye(4) * 0.05,
                                        gamma=25.0)
            for tid in tracks:
                lifetimes[tid] = lifetimes.get(tid, 0) + 1
            ref.manage_tracks(tracks, lifetimes, confirmed, 1, 2, 3, 4)
            log.append({t: (e.state.copy(), e.P.copy()) for t, e in tracks.items()})
        sides[name] = (log, confirmed)
        rng = np.random.default_rng(3)  # the same draws for the other side
    (plog, pconf), (jlog, jconf) = sides["port"], sides["jax"]
    assert pconf == jconf and pconf
    for p, j in zip(plog, jlog):
        assert list(p) == list(j)
        for t in p:
            np.testing.assert_array_equal(p[t][0], j[t][0])
            np.testing.assert_array_equal(p[t][1], j[t][1])


def test_tracking_api_as_the_jax_test_drives_it():
    clusters = {0: {"centroid": np.array([1.0, 2.0]), "measurement": [1.0, 2.0, 0.1, 0.2],
                    "eigenvalues": np.array([0.01, 0.02])}}
    tracks = compat.track_clusters({}, clusters, 1.0, np.eye(4) * 0.1, np.eye(4) * 0.05,
                                   gamma=0.5)
    assert list(tracks) == [1]
    confirmed = set()
    compat.manage_tracks(tracks, {1: 4}, confirmed, 1, 4, 10, 15)
    assert 1 in confirmed


@pytest.fixture(scope="module")
def pcd_seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("compat")
    return root, write_synthetic_sequence(SyntheticScene(seed=2), str(root / "s"), 4)


_PRE = ((0.2, 0.2), (-20, 20), (-20, 20), 2.0, (-20, 20, -20, 20, -3, 3))


@pytest.mark.parametrize("seed", [0, 3])
def test_preprocess_pcd_matches_jax(pcd_seq, seed):
    _, paths = pcd_seq
    got = compat.preprocess_pcd(paths[1], *_PRE, seed=seed, **CPU)
    want = jcompat.preprocess_pcd(paths[1], *_PRE, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (200, 200) and got.any()
    np.testing.assert_array_equal(got, want)


def test_preprocess_pcd_empty_roi_is_none(pcd_seq, capsys):
    _, paths = pcd_seq
    far = (50, 60, 50, 60, -3, 3)
    assert compat.preprocess_pcd(paths[0], *_PRE[:4], far, **CPU) is None
    assert jcompat.preprocess_pcd(paths[0], *_PRE[:4], far) is None
    assert "No ROI points" in capsys.readouterr().out


_SMALL = dict(max_raw_points=8192, max_roi_points=1024, max_cells=512, max_clusters=4,
              max_tracks=8)


@pytest.mark.parametrize("seed", [0, 5])
def test_process_multiple_frames_matches_jax(pcd_seq, seed):
    root, paths = pcd_seq
    got = compat.process_multiple_frames(
        paths, PipelineAConfig(capacities=CapacityConfig(**_SMALL)),
        output_dir=str(root / f"port{seed}"), seed=seed, **CPU)
    want = jcompat.process_multiple_frames(
        paths, JPipelineAConfig(capacities=JCapacity(**_SMALL)),
        output_dir=str(root / f"jax{seed}"), seed=seed)
    assert set(got) == set(want) and len(want) > 0
    for tid, state in want.items():
        np.testing.assert_allclose(got[tid], state, atol=5e-3, err_msg=f"track {tid}")
    for i in range(4):
        np.testing.assert_array_equal(np.load(root / f"port{seed}" / f"bev_frame_{i}.npy"),
                                      np.load(root / f"jax{seed}" / f"bev_frame_{i}.npy"))


def test_process_multiple_frames_takes_the_reference_dict(pcd_seq):
    root, paths = pcd_seq
    raw = {"grid_resolution": [0.2, 0.2], "x_range": [-20, 20], "y_range": [-20, 20],
           "z_max": 2.0, "roi_bounds": [-20, 20, -20, 20, -3, 3], "capacities": dict(_SMALL)}
    got = compat.process_multiple_frames(paths[:3], raw, output_dir=str(root / "dict"), **CPU)
    want = compat.process_multiple_frames(
        paths[:3], PipelineAConfig(capacities=CapacityConfig(**_SMALL), z_max=2.0,
                                   roi_bounds=(-20, 20, -20, 20, -3, 3)),
        output_dir=str(root / "obj"), **CPU)
    assert set(got) == set(want)
    for tid in want:
        np.testing.assert_array_equal(got[tid], want[tid])


def test_gmfa_process_files_seed(gmfa_seq, monkeypatch):
    """``seed=5``: frame i's preprocessing key, the expanded cloud and the
    step's track-id key are JAX's ``split(fold_in(PRNGKey(5), i))``."""
    _, paths = gmfa_seq
    seen = []
    preprocess, step = GMFAPipeline.preprocess, GMFAPipeline.step

    def record_preprocess(self, points, mask, key):
        out = preprocess(self, points, mask, key)
        seen.append({"kp": key.clone(), "cloud": [t.clone() for t in out]})
        return out

    def record_step(self, points, mask, carry, key):
        seen[-1]["ks"] = key.clone()
        return step(self, points, mask, carry, key)

    monkeypatch.setattr(GMFAPipeline, "preprocess", record_preprocess)
    monkeypatch.setattr(GMFAPipeline, "step", record_step)
    GMFAPipeline(_gmfa_cfg(), max_moving_points=2048, device="cpu").process_files(
        paths[:3], seed=5)
    assert len(seen) == 3 and "ks" not in seen[0] and all("ks" in s for s in seen[1:])
    from datmo_using_optical_flow_tpu_torch.io.frames import DiskFrameSource

    jpipe = _jax_gmfa()
    frames = list(DiskFrameSource(paths[:3], capacity=_GMFA_CAPS["max_raw_points"]))
    for i, (rec, (pts, mask)) in enumerate(zip(seen, frames)):
        kp, ks = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), i))
        np.testing.assert_array_equal(rec["kp"].numpy(), np.asarray(jax.random.key_data(kp)))
        if i:
            np.testing.assert_array_equal(rec["ks"].numpy(), np.asarray(jax.random.key_data(ks)))
        want = jpipe.preprocess(jnp.asarray(pts), jnp.asarray(mask), kp)
        for g, w in zip(rec["cloud"], want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not torch.equal(seen[1]["kp"], prng.split(prng.fold_in(prng.PRNGKey(0), 1))[0])


@pytest.mark.parametrize("module,names", [
    ("reference_a", ("extract_cluster_data", "RefEKF", "track_clusters", "manage_tracks")),
    ("viz", ("_plt", "_finish", "visualize_tracks", "visualize_filtered_clusters",
             "plot_moving_vs_static", "visualize_positions_and_velocities",
             "visualize_final_positions_and_velocities", "plot_filtered_cloud",
             "plot_som_heat_map"))])
def test_copies_match_the_jax_source(module, names):
    """The port's copies of the JAX package's numpy tracking oracle and
    plots are the same code."""
    port, jax_side = {"reference_a": (tref, jref), "viz": (tviz, jviz)}[module]
    for name in names:
        assert inspect.getsource(getattr(port, name)) == \
            inspect.getsource(getattr(jax_side, name)), name


_HIDDEN = """
import sys
for name in ("yaml", "matplotlib", "matplotlib.pyplot", "cv2", "sklearn"):
    sys.modules[name] = None
import datmo_using_optical_flow_tpu_torch.compat as compat
import datmo_using_optical_flow_tpu_torch.io.viz as viz
import datmo_using_optical_flow_tpu_torch.models.gmfa as gmfa
try:
    compat.load_config("config.yaml")
except ImportError:
    print("load_config needs yaml")
try:
    viz.plot_som_heat_map([[0.0]], save_path="x.png")
except ImportError:
    print("plots need matplotlib")
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "datmo_using_optical_flow_tpu")))
"""


def test_compat_and_viz_import_without_optional_packages(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _HIDDEN], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": _REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["load_config needs yaml", "plots need matplotlib", "[]"]
