"""The port's two benchmarks, their plumbing on the CPU at a small size: the
configurations they measure, the runner's per-frame breakdown and the
synchronised stage rows.  Their numbers come only from the card: ``run``
refuses the CPU."""

import os

import numpy as np
import pytest

from datmo_using_optical_flow_tpu_torch.benchmarks import from_points, stream_1080p
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig, RansacConfig
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
