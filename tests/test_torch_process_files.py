"""The slice end to end: five synthetic PCD frames through the JAX package's
``PipelineA.process_files`` (``use_pallas=True, fast_warp=True``, as its
benchmarks run it) and the port's, at a small configuration (4,096 raw
points, 300 RANSAC hypotheses, an 80x80 grid).  Also checkpoint and resume in
both directions and the ``run-a`` command line.

The preprocessing keys and draws are the same (``fold_in(PRNGKey(0), i)``),
RANSAC samples the same points and the BEV sums run in the JAX package's
order, so the BEVs come out equal: observed 0 of 5 x 6,400 cells differing,
and the test holds every frame's BEV to JAX's exactly.  (A RANSAC argmax
over counts that differ at points within rounding of the threshold could in
principle pick another plane; on this scene it picks JAX's in every frame.)
Tracks are held to ``test_torch_pipeline_a``'s 5e-3.
"""

import filecmp
import os

import numpy as np
import pytest
import yaml

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.config import RansacConfig as JRansac
from datmo_using_optical_flow_tpu.models.optical_flow_datmo import PipelineA as JPipelineA
from datmo_using_optical_flow_tpu_torch.__main__ import main as cli
from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, PipelineAConfig,
                                                       RansacConfig)
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              write_synthetic_sequence)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_KW = dict(x_range=(-8.0, 8.0), y_range=(-8.0, 8.0), roi_bounds=(-8.0, 8.0, -8.0, 8.0, -3.0, 1.0))
_CAP = dict(max_raw_points=4096, max_roi_points=1024, max_cells=1024, max_clusters=16,
            max_tracks=32)
_ITERS = 300
N_FRAMES = 5


def _cfg() -> PipelineAConfig:
    return PipelineAConfig(capacities=CapacityConfig(**_CAP),
                           ransac=RansacConfig(num_iterations=_ITERS), **_KW)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    scene = SyntheticScene(ground_points=2500, ground_extent=10.0, seed=21, targets=(
        BoxTarget(center0=(-3.0, -2.0, 0.75), velocity=(0.6, 0.3), points_per_frame=500),
        BoxTarget(center0=(3.0, 2.5, 0.75), velocity=(-0.4, -0.45), size=(3.0, 1.6, 1.4),
                  points_per_frame=500)))
    root = tmp_path_factory.mktemp("pf")
    return root, write_synthetic_sequence(scene, str(root / "seq"), N_FRAMES)


@pytest.fixture(scope="module")
def jax_run(seq):
    root, paths = seq
    cfg = JConfig(capacities=JCapacity(**_CAP), ransac=JRansac(num_iterations=_ITERS), **_KW)
    pipe = JPipelineA(cfg, fast_warp=True, use_pallas=True)
    out = str(root / "jax")
    summary = pipe.process_files(paths, output_dir=out)
    # a JAX checkpoint after 3 frames, for the port to resume from
    pipe.process_files(paths[:3], output_dir=str(root / "jax_part"), checkpoint_every=3,
                       checkpoint_path=str(root / "jax_state.npz"))
    return out, summary


@pytest.fixture(scope="module")
def port_run(seq):
    root, paths = seq
    out = str(root / "port")
    summary = PipelineA(_cfg(), "cpu").process_files(
        paths, output_dir=out, checkpoint_every=3, checkpoint_path=str(root / "port_state.npz"))
    return out, summary


def _assert_tracks_close(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want) and len(want) > 0
    for tid, st in want.items():
        np.testing.assert_allclose(got[tid], st, atol=atol, err_msg=f"track {tid}")


def test_process_files_matches_jax(jax_run, port_run):
    jdir, jsum = jax_run
    tdir, tsum = port_run
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    assert tsum["pairs"] == jsum["pairs"] == N_FRAMES - 1
    for i in range(N_FRAMES):
        a = np.load(os.path.join(jdir, f"bev_frame_{i}.npy"))
        b = np.load(os.path.join(tdir, f"bev_frame_{i}.npy"))
        assert a.dtype == b.dtype == np.uint8 and (a > 0).sum() > 50
        print(f"frame {i}: {int((a != b).sum())} of {a.size} BEV cells differing, "
              f"{int((a > 0).sum())} nonzero")
        np.testing.assert_array_equal(b, a, err_msg=f"bev_frame_{i}")
    _assert_tracks_close(tsum["tracks"], jsum["tracks"], atol=5e-3)
    for i in range(N_FRAMES - 1):  # each pair's track file names the same ids
        with open(os.path.join(jdir, f"ekf_tracks_frame_{i}.yaml")) as f:
            want = yaml.safe_load(f)
        with open(os.path.join(tdir, f"ekf_tracks_frame_{i}.yaml")) as f:
            got = yaml.safe_load(f)
        assert set(got) == set(want)


def test_resume_equals_uninterrupted_run(seq, port_run):
    root, paths = seq
    tdir, full = port_run
    ckpt = str(root / "resume_state.npz")
    pipe = PipelineA(_cfg(), "cpu")
    pipe.process_files(paths[:3], output_dir=str(root / "part1"), checkpoint_every=3,
                       checkpoint_path=ckpt)
    with np.load(ckpt) as data:
        assert int(data["step"]) == 3
    resumed = pipe.process_files(paths, output_dir=str(root / "part2"), checkpoint_path=ckpt,
                                 resume=True)
    assert resumed["pairs"] == full["pairs"] - 2  # pairs 2 and 3 (frames 3 and 4)
    assert set(resumed["tracks"]) == set(full["tracks"])
    for tid, st in full["tracks"].items():
        np.testing.assert_array_equal(resumed["tracks"][tid], st)
    for name in ("bev_frame_3.npy", "bev_frame_4.npy", "velocity_x_frame_3.npy",
                 "dbscan_labels_frame_3.npy", "ekf_tracks_frame_3.yaml"):
        assert filecmp.cmp(os.path.join(tdir, name), os.path.join(root / "part2", name),
                           shallow=False), name


def test_jax_checkpoint_resumes_in_the_port(seq, jax_run):
    root, paths = seq
    _, jsum = jax_run
    resumed = PipelineA(_cfg(), "cpu").process_files(
        paths, output_dir=str(root / "from_jax"), checkpoint_path=str(root / "jax_state.npz"),
        resume=True)
    assert resumed["pairs"] == N_FRAMES - 3
    _assert_tracks_close(resumed["tracks"], jsum["tracks"], atol=5e-3)


def test_q16_input(seq, port_run):
    """int16 points are dequantised exactly: preprocess of the q16 buffer
    equals preprocess of its float32 values; a q16 run keeps the tracks."""
    import torch

    from datmo_using_optical_flow_tpu_torch.io import frames as tfr
    from datmo_using_optical_flow_tpu_torch.utils import prng

    root, paths = seq
    _, f32 = port_run
    src = tfr.DiskFrameSource(paths[:1], capacity=_CAP["max_raw_points"], quantize_q16=True)
    (q, mask), = list(src)
    pipe = PipelineA(_cfg(), "cpu")
    key = prng.fold_in(prng.PRNGKey(0), 0)
    m = torch.as_tensor(mask)
    got = pipe.preprocess(torch.as_tensor(q), m, key)
    want = pipe.preprocess(tfr.dequantize_points_q16(torch.as_tensor(q)), m, key)
    assert torch.equal(got, want) and int((got > 0).sum()) > 50
    q16 = pipe.process_files(paths, output_dir=str(root / "q16"), h2d_q16=True)
    assert q16["pairs"] == f32["pairs"] and set(q16["tracks"]) == set(f32["tracks"])


def test_cli_run_a(seq, jax_run, tmp_path, capsys):
    root, paths = seq
    jdir, _ = jax_run
    config = {"input_folder": str(root / "seq"), "ransac": {"num_iterations": _ITERS},
              "capacities": dict(_CAP), **{k: list(v) for k, v in _KW.items()}}
    path = tmp_path / "a.yaml"
    path.write_text(yaml.safe_dump(config))
    out = tmp_path / "out"
    assert cli(["run-a", str(path), "-o", str(out), "--device", "cpu"]) == 0
    assert f"{N_FRAMES - 1} pairs" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == sorted(os.listdir(jdir))


def test_cli_argument_errors(tmp_path, capsys):
    one = tmp_path / "one"
    write_synthetic_sequence(SyntheticScene(ground_points=100, seed=1), str(one), 1)
    assert cli(["run-a", str(one), "--device", "cpu"]) == 1
    assert "need >= 2 PCD files" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        cli(["run-a", str(tmp_path / "missing"), "--device", "cpu"])
    assert cli(["simulate", "x"]) == 2
    assert "not ported" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):  # run-b is ported: a missing input raises
        cli(["run-b", str(tmp_path / "missing"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli(["run-a"])
    with pytest.raises(SystemExit):
        cli(["bogus"])
    assert cli(["synth", str(tmp_path / "syn"), "-n", "2"]) == 0
    assert sorted(os.listdir(tmp_path / "syn")) == ["lidar_frame_0.pcd", "lidar_frame_30.pcd"]


def test_bad_frame_is_skipped_and_device_errors_raise(seq, tmp_path, capsys):
    """A frame whose preprocessing fails is skipped and the stream goes on
    (the reference's per-frame except); a RuntimeError (torch's CUDA errors,
    the kernels' build and launch failures) ends the run."""
    _, paths = seq
    pipe = PipelineA(_cfg(), "cpu")
    original = pipe.preprocess
    calls = []

    def flaky(points, mask, key):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("bad frame")
        return original(points, mask, key)

    pipe.preprocess = flaky
    summary = pipe.process_files(paths, output_dir=str(tmp_path / "flaky"))
    assert "Error processing frame 2: bad frame" in capsys.readouterr().out
    assert summary["pairs"] == N_FRAMES - 2  # frame 2 is gone; frame 3 pairs with frame 1
    files = os.listdir(tmp_path / "flaky")
    assert "bev_frame_2.npy" not in files and "bev_frame_3.npy" in files

    def broken(points, mask, key):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    pipe.preprocess = broken
    with pytest.raises(RuntimeError, match="CUDA error"):
        pipe.process_files(paths, output_dir=str(tmp_path / "broken"))
