"""The port's ``process_files`` at the reference's data scale against the
reference's algorithm (the counterpart of ``tests/test_scale_parity.py``).

The same run as the JAX test (``test_scale_parity.py:33-53``): 11 frames of
a seed-77 synthetic scene of ~56,000 raw points (ground, one static box, two
movers) in 65,536-point buffers, a 200x200 BEV at 0.2 m, the exact warp
(``fast_warp=False``), on the CPU.  Then the same oracle and tolerances: the
reference loop (the JAX package's ``oracle/reference_a``: cv2 Farnebäck,
sklearn DBSCAN, the numpy EKF) replayed on the run's own BEV artifacts, every
pair's velocity grids within 2e-4, DBSCAN labels and indices exact, EKF track
ids exact and states within 5e-3, and the per-cell CSV non-trivial.
"""

import csv
import os

import numpy as np
import pytest
import yaml

from datmo_using_optical_flow_tpu.oracle import reference_a as ref
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              write_synthetic_sequence)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

N_FRAMES = 11  # >= 10 frame pairs

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = PipelineAConfig(  # defaults = reference scale: 200x200 grid @ 0.2 m
        capacities=CapacityConfig(max_raw_points=65536, max_roi_points=8192,
                                  max_cells=4096, max_clusters=32, max_tracks=64))
    assert cfg.grid_shape == (200, 200)
    scene = SyntheticScene(
        ground_points=48000, ground_extent=20.0,
        static_boxes=(BoxTarget(center0=(7.0, 7.0, 1.0), velocity=(0, 0),
                                points_per_frame=2000),),
        targets=(BoxTarget(center0=(-4.0, -2.0, 0.75), velocity=(0.55, 0.3),
                           points_per_frame=3000),
                 BoxTarget(center0=(4.0, 3.0, 0.75), velocity=(-0.4, -0.45),
                           size=(3.0, 1.6, 1.4), points_per_frame=3000)),
        seed=77,
    )
    seq_dir = str(tmp_path_factory.mktemp("scale_seq"))
    out_dir = str(tmp_path_factory.mktemp("scale_out"))
    paths = write_synthetic_sequence(scene, seq_dir, N_FRAMES)
    pipe = PipelineA(cfg, device="cpu", fast_warp=False)
    summary = pipe.process_files(paths, output_dir=out_dir, save_png=False, seed=0)
    return cfg, out_dir, summary


def test_reference_scale_run_is_nontrivial(run):
    cfg, out_dir, summary = run
    assert summary["pairs"] == N_FRAMES - 1
    assert len(summary["tracks"]) >= 1  # the movers are tracked at scale
    bev = np.load(os.path.join(out_dir, "bev_frame_0.npy"))
    assert bev.shape == (200, 200) and bev.dtype == np.uint8 and bev.max() > 0


def test_artifacts_match_reference_oracle_at_scale(run):
    cfg, out_dir, _ = run
    bevs = [np.load(os.path.join(out_dir, f"bev_frame_{i}.npy")) for i in range(N_FRAMES)]

    tracks = {}
    t = cfg.tracker
    for i in range(N_FRAMES - 1):
        # the reference loop (Optical_flow/main.py:561-634) on the run's own BEVs
        flow = ref.farneback_flow(bevs[i], bevs[i + 1])
        vx, vy, _ = ref.velocity_from_flow(flow, cfg.x_range, cfg.y_range)
        cont = ref.continuity_mask(vx, vy, cfg.masks.alpha_cont)
        vx_f, vy_f = vx * cont, vy * cont
        mag = np.sqrt(vx_f ** 2 + vy_f ** 2)
        valid = mag > cfg.velocity_threshold
        labels, idx = ref.dbscan_clustering(vx_f, vy_f, valid, cfg.dbscan.eps,
                                            cfg.dbscan.min_samples)
        clusters = ref.extract_cluster_data(labels, idx, vx_f, vy_f)
        tracks = ref.track_clusters(tracks, clusters, cfg.dt,
                                    np.eye(4) * t.process_noise,
                                    np.eye(4) * t.measurement_noise, t.gamma)

        got_vx = np.load(os.path.join(out_dir, f"velocity_x_frame_{i}.npy"))
        got_vy = np.load(os.path.join(out_dir, f"velocity_y_frame_{i}.npy"))
        np.testing.assert_allclose(got_vx, vx_f, atol=2e-4, err_msg=f"pair {i} vx")
        np.testing.assert_allclose(got_vy, vy_f, atol=2e-4, err_msg=f"pair {i} vy")

        got_labels = np.load(os.path.join(out_dir, f"dbscan_labels_frame_{i}.npy"))
        got_idx = np.load(os.path.join(out_dir, f"dbscan_indices_frame_{i}.npy"))
        assert got_labels.shape[0] == labels.shape[0], f"pair {i} cell count"
        np.testing.assert_array_equal(got_idx, idx, err_msg=f"pair {i} indices")
        np.testing.assert_array_equal(got_labels, labels, err_msg=f"pair {i} labels")

        with open(os.path.join(out_dir, f"ekf_tracks_frame_{i}.yaml")) as f:
            got_tracks = yaml.safe_load(f) or {}
        exp_tracks = {tid: ekf.state.flatten() for tid, ekf in tracks.items()}
        assert set(got_tracks) == set(exp_tracks), f"pair {i} track ids"
        for tid, exp_state in exp_tracks.items():
            np.testing.assert_allclose(np.asarray(got_tracks[tid], dtype=float), exp_state,
                                       atol=5e-3, err_msg=f"pair {i} track {tid}")

    # per-cell CSV: one row per DBSCAN-valid cell per pair (saving_utils.py:17-46)
    with open(os.path.join(out_dir, "filtered_velocities.csv")) as f:
        rows = list(csv.reader(f))
    assert sum(1 for r in rows[1:] if r) > 100  # nontrivial at this scale
