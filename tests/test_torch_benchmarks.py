"""The port's three benchmarks, their plumbing on the CPU at a small size:
the configurations they measure, the runner's per-frame breakdown, GMFA's
timed sweeps and the synchronised stage rows.  Their numbers come only from
the card: ``run`` refuses the CPU."""

import os

import numpy as np
import pytest

from datmo_using_optical_flow_tpu_torch.benchmarks import (from_points, gmfa_reference_load,
                                                            stream_1080p)
from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig, GMFAConfig,
                                                       IcpConfig, PipelineAConfig, RansacConfig)
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              synthetic_frame,
                                                              write_synthetic_sequence)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_configurations_are_the_jax_scripts():
    assert stream_1080p.config().grid_shape == (1080, 1920)
    caps = stream_1080p.config().capacities
    assert (caps.max_cells, caps.max_clusters, caps.max_tracks) == (4096, 32, 64)
    cfg = from_points.config()
    assert cfg.grid_shape == (200, 200) and cfg.ransac.num_iterations == 5000
    caps = cfg.capacities
    assert (caps.max_raw_points, caps.max_roi_points, caps.expansion_factor) == (65536, 8192, 10)
    assert len(synthetic_frame(from_points.scene(), 0)) == 56000  # the CARLA-spec frame


@pytest.mark.parametrize("module", [stream_1080p, from_points])
def test_run_refuses_the_cpu(module):
    with pytest.raises(RuntimeError, match="CUDA"):
        module.run("cpu")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    kw = dict(x_range=(-8.0, 8.0), y_range=(-8.0, 8.0),
              roi_bounds=(-8.0, 8.0, -8.0, 8.0, -3.0, 1.0))
    cfg = PipelineAConfig(capacities=CapacityConfig(max_raw_points=4096, max_roi_points=1024,
                                                    max_cells=1024, max_clusters=16,
                                                    max_tracks=32),
                          ransac=RansacConfig(num_iterations=200), **kw)
    scene = SyntheticScene(ground_points=2500, ground_extent=10.0, seed=3, targets=(
        BoxTarget(center0=(-3.0, -2.0, 0.75), velocity=(0.6, 0.3), points_per_frame=400),))
    root = tmp_path_factory.mktemp("bench")
    return PipelineA(cfg, "cpu"), write_synthetic_sequence(scene, str(root / "seq"), 4), root


@pytest.mark.parametrize("q16", [False, True])
def test_timed_run_breakdown(small, q16):
    pipe, paths, root = small
    rec = from_points.timed_run(pipe, paths, str(root / f"out{int(q16)}"), q16)
    assert rec["summary"]["pairs"] == len(paths) - 1 and rec["fps"] > 0
    b = rec["breakdown_ms_per_frame"]
    assert set(b) == {"preprocess", "step", "artifacts", "artifacts_transfer", "io_decode_other"}
    assert all(np.isfinite(v) for v in b.values()) and b["preprocess"] > 0 and b["step"] > 0


def test_stage_rows(small):
    pipe, paths, root = small
    rows = from_points.stage_rows(pipe, paths, str(root / "stages"), "cpu", reps=1)
    names = [r["name"] for r in rows]
    assert names[0] == "decode and pad (host)" and names[-1] == "artifact files (host)"
    assert "stream step" in names and "preprocess (whole)" in names
    for r in rows:
        assert r["ms"] > 0 and r["device_ms"] is None  # no device time on the CPU
    assert os.path.exists(root / "stages" / "bev_frame_2.npy")


def test_gmfa_reference_load_is_the_jax_script():
    cfg = gmfa_reference_load.config()
    caps = cfg.capacities
    assert (caps.max_raw_points, caps.max_roi_points, caps.max_expanded_points) == \
        (65536, 10240, 102400)
    assert (caps.max_cells, caps.max_clusters, caps.max_tracks) == (4096, 32, 64)
    assert (cfg.dbscan.eps, cfg.dbscan.min_samples) == (5.0, 1000)
    assert (cfg.icp.threshold, cfg.icp.max_iterations, cfg.ransac.num_iterations) == \
        (0.02, 30, 5000)
    assert gmfa_reference_load.MAX_MOVING == 16384 and gmfa_reference_load.N_FRAMES == 7
    assert len(synthetic_frame(gmfa_reference_load.scene(), 0)) == 56000
    with pytest.raises(RuntimeError, match="CUDA"):
        gmfa_reference_load.run("cpu")


def test_gmfa_reference_load_plumbing(tmp_path):
    """``measure`` on the CPU at a tiny size: preprocessed clouds, the timed
    sweeps, the preprocess rows (no device time on the CPU) and the file
    runner on the same frames as PCD files."""
    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=20), icp=IcpConfig(threshold=0.2),
                     ransac=RansacConfig(num_iterations=100),
                     capacities=CapacityConfig(max_raw_points=2048, max_roi_points=128,
                                               max_cells=256, max_clusters=4, max_tracks=8))
    scene = SyntheticScene(ground_points=1500, ground_extent=10.0, seed=4, targets=(
        BoxTarget(center0=(3.0, -2.0, 0.75), velocity=(1.5, 0.8), points_per_frame=150),))
    pipe = GMFAPipeline(cfg, max_moving_points=512, device="cpu")
    paths = write_synthetic_sequence(scene, str(tmp_path), 3, dt=cfg.dt)
    rec = gmfa_reference_load.measure(pipe, gmfa_reference_load.raw_frames(cfg, scene, 3),
                                      paths, sweeps=1, card="cpu")
    assert rec["metric"] == "gmfa_fps_reference_load" and rec["value"] > 0
    assert rec["steps"] == 2 and len(rec["moving_points_per_step"]) == 2
    assert rec["expanded_points_per_frame"][0] == rec["expanded_points"] > 0
    assert rec["moving_cap"] == 512
    assert rec["moving_cap_hit"] == [m >= 512 for m in rec["moving_points_per_step"]]
    assert [r["name"] for r in rec["stages"]][0] == "preprocess (whole)"
    assert all(r["ms"] > 0 and r["device_ms"] is None for r in rec["stages"])
    assert rec["runner_fps"] > 0 and rec["runner_fps_q16"] > 0
    assert set(rec["runner_host_ms_per_frame"]) == {"preprocess", "step", "track_log",
                                                    "track_log_transfer"}
