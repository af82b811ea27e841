"""The quality surface of the port against the JAX package: ``utils/metrics``,
the scenes' ground truth, ``io/artifacts.read_yaml_tracks``,
``models/tracker_a.track_step`` and the quality benchmark's two evaluations,
``benchmarks/quality.eval_pipeline_a`` and ``eval_gmfa``, against those of
``benchmarks/bench_quality.py`` (loaded by path) on one scene of 6 frames at a
quick configuration (both sides' capacities cut the same way)."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from datmo_using_optical_flow_tpu import config as jcfg
from datmo_using_optical_flow_tpu.models import gmfa as jgmfa
from datmo_using_optical_flow_tpu.models import tracker_a as jtrk
from datmo_using_optical_flow_tpu.sim import synthetic as jsyn
from datmo_using_optical_flow_tpu.utils import metrics as jmet
from datmo_using_optical_flow_tpu_torch.benchmarks import evaluate, quality
from datmo_using_optical_flow_tpu_torch.io import artifacts
from datmo_using_optical_flow_tpu_torch.models import tracker_a as ttrk
from datmo_using_optical_flow_tpu_torch.sim import synthetic as tsyn
from datmo_using_optical_flow_tpu_torch.utils import metrics as tmet
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_QUICK = 6
# the quick configuration: capacities cut on both sides (the benchmark's
# 16384 raw / 4096 ROI points and 16384 moving take minutes on this CPU)
_SMALL = dict(max_raw_points=8192, max_roi_points=256, max_cells=2048)
_MOVING = 1024


@pytest.fixture(scope="module")
def bench_quality():
    spec = importlib.util.spec_from_file_location(
        "bench_quality", os.path.join(_REPO, "benchmarks", "bench_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metrics_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    flow, ref = rng.normal(size=(2, 30, 40, 2))
    assert tmet.flow_epe(flow, ref) == jmet.flow_epe(flow, ref)
    for n in (0, 1, 7):
        est, gt = rng.normal(size=(2, n, 2))
        assert tmet.velocity_accuracy(est, gt) == jmet.velocity_accuracy(est, gt)
    for n_det, n_gt, gate in ((0, 3, 2.0), (4, 0, 2.0), (5, 4, 1.0), (6, 6, 3.0)):
        det, gt = rng.uniform(-3, 3, size=(n_det, 2)), rng.uniform(-3, 3, size=(n_gt, 2))
        assert tmet.detection_pr(det, gt, gate) == jmet.detection_pr(det, gt, gate)
    ticks = iter(np.arange(0.0, 10.0, 0.3))  # one clock for both counters
    now = [0.0]

    def clock():
        now[0] = float(next(ticks))
        return now[0]

    for mod in (tmet, jmet):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    counters = (tmet.FpsCounter(window=1.0), jmet.FpsCounter(window=1.0))
    for _ in range(20):
        clock()
        assert counters[0].tick(2) == counters[1].tick(2)
    for mod, name in ((tmet, "t.jsonl"), (jmet, "j.jsonl")):
        log = mod.MetricsLog(str(tmp_path / name))
        log.append(0, epe=0.5, fps=12.0)
        log.append(1, note="x")
        log.flush()
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()


def test_ground_truth_matches_jax(bench_quality):
    """The quality scenes (and their ground truth) equal the JAX script's."""
    ours, theirs = list(quality.scenes()), list(bench_quality.scenes())
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (_, ts), (_, js) in zip(ours, theirs):
        assert str(dataclasses.asdict(ts)) == str(dataclasses.asdict(js))
        for frame in range(0, 52, 5):
            for dt in (1.0, 0.1):
                for a, b in zip(tsyn.ground_truth(ts, frame, dt),
                                jsyn.ground_truth(js, frame, dt)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                for tb, jb in zip(ts.targets, js.targets):
                    np.testing.assert_array_equal(tsyn.target_velocity(tb, frame, dt),
                                                  jsyn.target_velocity(jb, frame, dt))
    box = tsyn.BoxTarget(velocity=(1.0, -0.5), accel=(0.2, 0.1), spawn_frame=2)
    jbox = jsyn.BoxTarget(velocity=(1.0, -0.5), accel=(0.2, 0.1), spawn_frame=2)
    np.testing.assert_array_equal(tsyn.target_velocity(box, 4, 0.5),
                                  jsyn.target_velocity(jbox, 4, 0.5))
    for frame in (0, 1, 2, 3):  # an inactive target has no truth
        for a, b in zip(tsyn.ground_truth(tsyn.SyntheticScene(targets=(box,)), frame),
                        jsyn.ground_truth(jsyn.SyntheticScene(targets=(jbox,)), frame)):
            np.testing.assert_array_equal(a, b)


def test_read_yaml_tracks_is_yaml_safe_load():
    rng = np.random.default_rng(1)
    cases = [{}, {3: [1.0, 2.5, -0.1, 1e-05]}, {10: [1e17, -0.0, 0.0, 123456789.123]},
             {1: [float("nan"), float("inf"), -float("inf"), 1e-300]}]
    for _ in range(100):
        n = int(rng.integers(0, 6))
        scale = 10.0 ** float(rng.integers(-8, 9))
        cases.append({int(k): [float(np.float32(x)) for x in rng.normal(scale=scale, size=4)]
                      for k in rng.integers(-5, 100000, n)})
    for case in cases:
        text = artifacts.yaml_tracks(case)
        got, want = artifacts.read_yaml_tracks(text), yaml.safe_load(text)
        assert repr(got) == repr(want), text  # repr: nan == nan
    with pytest.raises(ValueError):
        artifacts.read_yaml_tracks("a: {b: 1}\n")


def _cluster_frames(n_frames, k, seed):
    """Cluster slots of drifting objects that vanish and return, two claimants
    of one track, and a one-cell cluster (NaN eigenvalues)."""
    rng = np.random.default_rng(seed)
    pos = np.array([[5.0, 5.0], [20.0, 8.0], [12.0, 30.0]])
    for t in range(n_frames):
        exists = np.zeros(k, bool)
        cen = np.zeros((k, 2), np.float32)
        eig = np.zeros((k, 2), np.float32)
        vel = rng.normal(scale=0.2, size=(k, 2)).astype(np.float32)
        pos = pos + rng.normal(scale=0.05, size=pos.shape)
        for j in range(3):
            if (j == 0 and t < 6) or (t >= 6 and (t + j) % 5 != 4):
                exists[j], cen[j], eig[j] = True, pos[j], rng.uniform(0.0, 0.2, 2)
        if t >= 6 and t % 3 == 1:
            exists[3], cen[3], eig[3] = True, pos[0] + 0.1, (0.05, 0.01)
        if t >= 6 and t % 4 == 2:
            exists[4], cen[4], eig[4] = True, (3.0, 33.0), (np.nan, np.nan)
        yield exists, cen, np.concatenate([cen, vel], axis=1).astype(np.float32), eig


def test_track_step_matches_jax():
    """``track_step`` frame after frame, each side carrying its own table:
    ids, alive flags, lifetimes and confirmations exact, states and
    covariances atol 1e-5; confirmed tracks die and are reborn."""
    cap, k = 6, 5
    jstep = jax.jit(jtrk.track_step, static_argnums=tuple(range(2, 10)))
    jt, tt = jtrk.new_track_table(cap), ttrk.new_track_table(cap)
    deleted = 0
    for exists, cen, meas, eig in _cluster_frames(24, k, seed=4):
        jc = jtrk.Clusters(*map(jnp.asarray, (exists, cen, meas, eig)))
        tc = ttrk.Clusters(*map(torch.as_tensor, (exists, cen, meas, eig)))
        before = np.asarray(jt.alive)
        jt = jstep(jt, jc, 1.0, 0.1, 0.05, 0.5, 1, 2, 1, 3)
        tt = ttrk.track_step(tt, tc, 1.0, 0.1, 0.05, 0.5, 1, 2, 1, 3)
        for name in ("tid", "alive", "lifetime", "confirmed"):
            np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
        for name in ("state", "cov"):
            np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                       atol=1e-5)
        deleted += int(np.sum(before & ~np.asarray(jt.alive)))
    assert deleted > 0


def _quick(monkeypatch, bench_quality):
    """Both sides' evaluations at the quick configuration, ``N_QUICK`` frames."""
    monkeypatch.setattr(bench_quality, "N_FRAMES", N_QUICK)
    real_caps, real_gmfa = jcfg.CapacityConfig, jgmfa.GMFAPipeline
    monkeypatch.setattr(jcfg, "CapacityConfig", lambda **kw: real_caps(**{**kw, **_SMALL}))
    monkeypatch.setattr(jgmfa, "GMFAPipeline",
                        lambda cfg, max_moving_points: real_gmfa(cfg, max_moving_points=_MOVING))
    g_cfg, a_cfg = quality.gmfa_config, quality.pipeline_a_config

    def small(cfg):
        return dataclasses.replace(cfg, capacities=dataclasses.replace(cfg.capacities, **_SMALL))

    monkeypatch.setattr(quality, "gmfa_config", lambda: small(g_cfg()))
    monkeypatch.setattr(quality, "pipeline_a_config", lambda: small(a_cfg()))
    monkeypatch.setattr(quality, "GMFA_MAX_MOVING", _MOVING)


@pytest.fixture(scope="module")
def easy(tmp_path_factory):
    name, scene = next(iter(quality.scenes()))
    root = tmp_path_factory.mktemp("quality")
    return scene, tsyn.write_synthetic_sequence(scene, str(root / name), N_QUICK), root


def test_eval_pipeline_a_matches_bench_quality(easy, bench_quality, monkeypatch):
    """Pipeline A on the easy scene: the report's detections, velocity error
    and pairs equal to the JAX script's; the oracle's velocity grids (the
    numpy model of cv2 here, cv2 there) within 1e-5 m/s; every DBSCAN
    partition equal on both sides; without sklearn the partitions say so."""
    scene, paths, root = easy
    _quick(monkeypatch, bench_quality)
    got = quality.eval_pipeline_a(scene, paths, 1.0, str(root / "port"), "cpu")
    want = bench_quality.eval_pipeline_a(scene, paths, 1.0, str(root / "jax"))
    for key in ("precision", "recall", "tp", "fp", "fn", "velocity_mae_mps", "pairs"):
        assert got[key] == want[key], key
    assert got["tp"] > 0
    ours, theirs = got["oracle_agreement"], want["oracle_agreement"]
    assert ours["velocity_grid_max_abs_diff_mps"] <= 1e-5
    assert theirs["velocity_grid_max_abs_diff_mps"] <= 1e-5
    assert ours["dbscan_label_partitions_equal"] == theirs["dbscan_label_partitions_equal"] \
        == f"{N_QUICK - 1}/{N_QUICK - 1}"
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    blocked = quality.oracle_agreement(str(root / "port" / "a_artifacts"),
                                       quality.pipeline_a_config(), N_QUICK)
    assert blocked["dbscan_label_partitions_equal"] == "not run: no sklearn"
    assert blocked["velocity_grid_max_abs_diff_mps"] == ours["velocity_grid_max_abs_diff_mps"]
    json.dumps(got)


def test_eval_gmfa_matches_bench_quality(easy, bench_quality, monkeypatch):
    """GMFA on the easy scene: JAX's and the port's runs part after ICP's
    gate (ROADMAP Queue 3, "Known"), so tp, fp and fn are held within 1 of
    the JAX script's each and the velocity error within 0.02 m/s (equal at
    this size when written)."""
    scene, paths, _ = easy
    _quick(monkeypatch, bench_quality)
    got = quality.eval_gmfa(scene, paths, 1.0, "cpu")
    want = bench_quality.eval_gmfa(scene, paths, 1.0)
    for key in ("tp", "fp", "fn"):
        assert abs(got[key] - want[key]) <= 1, (key, got, want)
    assert got["tp"] > 0 and got["frames"] == want["frames"] == N_QUICK
    assert abs(got["velocity_mae_mps"] - want["velocity_mae_mps"]) <= 0.02
    assert got["fps"] > 0


@pytest.mark.parametrize("run", [quality.run, evaluate.run])
def test_benchmarks_refuse_the_cpu(run):
    with pytest.raises(RuntimeError, match="CUDA"):
        run("cpu")
