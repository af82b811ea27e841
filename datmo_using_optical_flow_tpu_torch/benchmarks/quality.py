"""Detection quality of both pipelines on adversarial synthetic clips, on
the card: the port's ``benchmarks/bench_quality.py``.

The JAX script's six scenes (``easy``, ``crossing_clutter``, ``occlusion``,
``turn_tight``, ``noise_hi``, ``sparse``), each ``N_FRAMES = 52`` frames
written as PCD files (``dt = 1``), run through GMFA (``max_moving_points
16384``) and pipeline A (``fast_warp=False``, ``max_cells 16384``) with the
JAX script's configurations.  Per scene and pipeline: detection precision
and recall against the ground truth (greedy matching within ``GATE_M = 3.0``
m per frame, truths outside the pipeline's region ignored), the matched
tracks' velocity error, and for pipeline A the agreement of its artifacts
with the CPU oracle loop replayed on the run's own BEVs: the velocity grids
against the numpy model of cv2 (``oracle/reference_a.farneback_flow``; the
JAX script calls cv2), the DBSCAN label partitions against sklearn's DBSCAN
where sklearn imports (else the field says so: this card's machine has no
sklearn).  ``--frames`` and ``--scenes`` shorten the run.  Prints one JSON
line with the card's name and power limit.

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.quality \
        [--frames N] [--scenes easy,occlusion]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig, GMFAConfig,
                                                       IcpConfig, PipelineAConfig)
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label
from datmo_using_optical_flow_tpu_torch.io.artifacts import read_yaml_tracks
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.oracle import reference_a as ref
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              ground_truth,
                                                              write_synthetic_sequence)
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

N_FRAMES = 52
GATE_M = 3.0
GMFA_MAX_MOVING = 16384
WARMUP = 3  # the trackers need a couple of frames of history


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def scenes():
    """The JAX script's scenes, in its order.  GMFA labels a point moving only
    above 0.6 m of residual per frame, and A's ROI is +-10 m, so the targets
    circle at >= 0.62 m/frame inside every ROI."""
    # R = 5 m circle about (0, -1): speed 0.65, inside every ROI, y <= 4
    circle = BoxTarget(center0=(5.0, -1.0, 0.75), velocity=(0.0, 0.65),
                       turn_rate=0.13, points_per_frame=600)
    easy = dict(ground_points=4000, ground_extent=20.0, seed=101,
                targets=(circle,))
    yield "easy", SyntheticScene(**easy)

    yield "crossing_clutter", SyntheticScene(
        ground_points=4000, ground_extent=20.0, seed=102,
        static_boxes=(BoxTarget(center0=(-8.0, -8.0, 1.0), velocity=(0, 0),
                                points_per_frame=800),),
        targets=(
            # concentric circles (R = 5 and 7.2) at different angular rates
            circle,
            BoxTarget(center0=(-7.2, -1.0, 0.75), velocity=(0.0, -0.65),
                      turn_rate=0.09, size=(3.0, 1.6, 1.4),
                      points_per_frame=600),
        ),
        clutter_blobs=5, clutter_points=40,
    )

    yield "occlusion", SyntheticScene(
        ground_points=4000, ground_extent=20.0, seed=103, occlusion=True,
        static_boxes=(BoxTarget(center0=(4.0, 1.6, 1.25),
                                size=(5.0, 3.0, 2.5), velocity=(0, 0),
                                points_per_frame=1200),),
        targets=(
            # a straight pass through the box's shadow (frames ~18-28)
            BoxTarget(center0=(8.0, -9.5, 0.75), velocity=(0.0, 0.62),
                      points_per_frame=600),
        ),
    )

    yield "turn_tight", SyntheticScene(
        ground_points=4000, ground_extent=20.0, seed=104,
        targets=(
            # R = 3 m at 0.66 m/frame: the heading turns ~12.6 deg per frame
            BoxTarget(center0=(3.0, -2.0, 0.75), velocity=(0.0, 0.66),
                      turn_rate=0.22, points_per_frame=600),
        ),
    )

    hi = dict(easy)
    hi.update(seed=105, sensor_noise=0.08)
    yield "noise_hi", SyntheticScene(**hi)

    sparse = dict(easy)
    sparse.update(
        seed=106, ground_points=1200,
        targets=(BoxTarget(center0=(5.0, -1.0, 0.75), velocity=(0.0, 0.65),
                           turn_rate=0.13, points_per_frame=150),))
    yield "sparse", SyntheticScene(**sparse)


def greedy_match(det: np.ndarray, gt: np.ndarray, gate: float):
    """Greedy nearest matching (the utils.metrics.detection_pr rule), returning
    (pairs, tp, fp, fn) where pairs is a list of (det_row, gt_row) indices."""
    det = np.atleast_2d(det).reshape(-1, 2)
    gt = np.atleast_2d(gt).reshape(-1, 2)
    matched: set[int] = set()
    pairs = []
    for ti, t in enumerate(gt):
        if det.shape[0] == 0:
            break
        d = np.linalg.norm(det - t, axis=1)
        d[list(matched)] = np.inf
        j = int(np.argmin(d))
        if d[j] <= gate:
            matched.add(j)
            pairs.append((j, ti))
    tp = len(pairs)
    return pairs, tp, det.shape[0] - tp, gt.shape[0] - tp


class PRAccum:
    def __init__(self):
        self.tp = self.fp = self.fn = 0
        self.vel_err: list[float] = []

    def add(self, det_pos, det_vel, gt_pos, gt_vel, gate=GATE_M,
            gt_in_region=None):
        """``gt_in_region``: boolean mask over GT rows — a truth outside the
        pipeline's detectable region (pipeline A's +-10 m ROI, GMFA's moving
        ROI) is an IGNORE region, not a miss: detections matched to it are
        dropped from both TP and FP, and it never counts as FN."""
        gt_pos = np.atleast_2d(gt_pos).reshape(-1, 2)
        if gt_in_region is None:
            gt_in_region = np.ones(len(gt_pos), bool)
        pairs, _tp, _fp, _fn = greedy_match(det_pos, gt_pos, gate)
        matched_det = {dj for dj, _ in pairs}
        kept = [(dj, ti) for dj, ti in pairs if gt_in_region[ti]]
        self.tp += len(kept)
        n_det = np.atleast_2d(det_pos).reshape(-1, 2).shape[0]
        self.fp += n_det - len(matched_det)
        matched_gt = {ti for _, ti in pairs}
        self.fn += int(sum(1 for ti in range(len(gt_pos))
                           if gt_in_region[ti] and ti not in matched_gt))
        for dj, ti in kept:
            if det_vel is not None:
                self.vel_err.append(float(np.linalg.norm(
                    np.asarray(det_vel)[dj] - np.asarray(gt_vel)[ti])))

    def report(self) -> dict:
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        return {
            "precision": round(prec, 4), "recall": round(rec, 4),
            "tp": self.tp, "fp": self.fp, "fn": self.fn,
            "velocity_mae_mps": (round(float(np.mean(self.vel_err)), 4)
                                 if self.vel_err else None),
        }


def _flipped_truth(scene, frame: int, dt_scene: float):
    """Ground truth in the pipelines' frame: preprocess flips x."""
    gt_pos, gt_vel = ground_truth(scene, frame, dt_scene)
    return gt_pos * np.array([-1.0, 1.0]), gt_vel * np.array([-1.0, 1.0])


def _in_box(pos: np.ndarray, x_lo: float, x_hi: float, y_lo: float, y_hi: float,
            margin: float = 0.5) -> np.ndarray:
    return ((pos[:, 0] > x_lo + margin) & (pos[:, 0] < x_hi - margin)
            & (pos[:, 1] > y_lo + margin) & (pos[:, 1] < y_hi - margin))


def gmfa_config() -> GMFAConfig:
    return GMFAConfig(
        dbscan=DbscanConfig(eps=1.0, min_samples=150),
        icp=IcpConfig(threshold=0.1),
        capacities=CapacityConfig(max_raw_points=16384, max_roi_points=4096,
                                  max_cells=4096, max_clusters=16, max_tracks=32))


def pipeline_a_config() -> PipelineAConfig:
    # max_cells 16384: the clutter scenes exceed 4096 moving cells, and the
    # truncation would hide clusters and part the DBSCAN artifacts from the
    # uncapped oracle
    return PipelineAConfig(
        capacities=CapacityConfig(max_raw_points=16384, max_roi_points=4096,
                                  max_cells=16384, max_clusters=32, max_tracks=32))


def eval_gmfa(scene, paths, dt_scene: float, device: str | torch.device = "cuda") -> dict:
    """GMFA (pipeline B): track rows against the ground truth.  Its positions
    are in flipped-x meters; its velocities are per ``cfg.dt`` (0.1 s) while
    the scene advances ``dt_scene`` per frame, so they scale by ``cfg.dt /
    dt_scene``.  The region: GMFA's ROI within its moving ROI."""
    cfg = gmfa_config()
    n_frames = len(paths)
    pipe = GMFAPipeline(cfg, max_moving_points=GMFA_MAX_MOVING, device=device)
    with contextlib.redirect_stdout(sys.stderr):  # keep stdout JSON-clean
        out = pipe.process_files(paths)
    by_frame: dict[int, list[dict]] = {}
    for row in out["rows"]:
        by_frame.setdefault(int(row["Frame"]), []).append(row)
    rb, mb = cfg.roi_bounds, cfg.moving_roi_bounds
    acc = PRAccum()
    for f in range(WARMUP, n_frames - 1):
        rows = by_frame.get(f, [])
        det_pos = np.array([[r["X"], r["Y"]] for r in rows]).reshape(-1, 2)
        det_vel = np.array([[r["VX"], r["VY"]] for r in rows]).reshape(-1, 2) \
            * (cfg.dt / dt_scene)
        gt_pos, gt_vel = _flipped_truth(scene, f + 1, dt_scene)
        in_region = _in_box(gt_pos, max(rb[0], mb[0]), min(rb[1], mb[1]),
                            max(rb[2], mb[2]), min(rb[3], mb[3]))
        acc.add(det_pos, det_vel, gt_pos, gt_vel, gt_in_region=in_region)
    rep = acc.report()
    rep["frames"] = n_frames
    rep["fps"] = (n_frames - 1) / max(out["elapsed"], 1e-9)
    return rep


def oracle_agreement(out_dir: str, cfg: PipelineAConfig, n_frames: int) -> dict:
    """Pipeline A's artifacts against the CPU oracle loop replayed on the
    run's own BEVs: the filtered velocity grids (largest difference) and the
    DBSCAN label partitions (pairs exactly equal), or ``"not run: no
    sklearn"`` where sklearn does not import."""
    try:
        import sklearn.cluster  # noqa: F401
    except ImportError:
        have_sklearn = False
    else:
        have_sklearn = True
    bevs = [np.load(os.path.join(out_dir, f"bev_frame_{i}.npy")) for i in range(n_frames)]
    max_v = 0.0
    labels_equal = pairs_total = 0
    for i in range(n_frames - 1):
        if not os.path.exists(os.path.join(out_dir, f"velocity_x_frame_{i}.npy")):
            continue  # a skipped pair (invalid BEV) writes no pair artifacts
        flow = ref.farneback_flow(bevs[i], bevs[i + 1])
        vx, vy, _ = ref.velocity_from_flow(flow, cfg.x_range, cfg.y_range)
        cont = ref.continuity_mask(vx, vy, cfg.masks.alpha_cont)
        vx_f, vy_f = vx * cont, vy * cont
        got_vx = np.load(os.path.join(out_dir, f"velocity_x_frame_{i}.npy"))
        got_vy = np.load(os.path.join(out_dir, f"velocity_y_frame_{i}.npy"))
        max_v = max(max_v, float(np.abs(got_vx - vx_f).max()),
                    float(np.abs(got_vy - vy_f).max()))
        pairs_total += 1
        if not have_sklearn:
            continue
        valid = np.sqrt(vx_f ** 2 + vy_f ** 2) > cfg.velocity_threshold
        labels, idx = ref.dbscan_clustering(vx_f, vy_f, valid, cfg.dbscan.eps,
                                            cfg.dbscan.min_samples)
        got_l = np.load(os.path.join(out_dir, f"dbscan_labels_frame_{i}.npy"))
        got_i = np.load(os.path.join(out_dir, f"dbscan_indices_frame_{i}.npy"))
        if (got_l.shape == np.asarray(labels).shape and np.array_equal(got_l, labels)
                and np.array_equal(got_i, idx)):
            labels_equal += 1
    return {
        "bev_source": "the run's own uint8 BEV artifacts",
        "velocity_reference": "oracle/np_farneback.calc_flow (the numpy model of cv2)",
        "velocity_grid_max_abs_diff_mps": max_v,
        "dbscan_label_partitions_equal": (f"{labels_equal}/{pairs_total}" if have_sklearn
                                          else "not run: no sklearn"),
    }


def eval_pipeline_a(scene, paths, dt_scene: float, workdir: str,
                    device: str | torch.device = "cuda") -> dict:
    """Pipeline A: the per-pair EKF track files against the ground truth,
    then :func:`oracle_agreement`.  A track's state ``[cx, cy]`` is in BEV
    cells (row = x bin, col = y bin); its velocity axes come from the flow
    (dx along axis 1, the y bins), so the world (vx, vy) is the state's
    (vy, vx), a quirk of the reference kept as it is."""
    cfg = pipeline_a_config()
    n_frames = len(paths)
    out_dir = os.path.join(workdir, "a_artifacts")
    pipe = PipelineA(cfg, device, fast_warp=False)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # keep stdout JSON-clean
        summary = pipe.process_files(paths, output_dir=out_dir, save_png=False, seed=0)
    elapsed = time.perf_counter() - t0
    res_x, res_y = cfg.grid_resolution
    x0, y0 = cfg.x_range[0], cfg.y_range[0]
    rb = cfg.roi_bounds
    acc = PRAccum()
    for pair in range(WARMUP, n_frames - 1):
        p = os.path.join(out_dir, f"ekf_tracks_frame_{pair}.yaml")
        tracks = {}
        if os.path.exists(p):
            with open(p) as f:
                tracks = read_yaml_tracks(f.read())
        det_pos = [[x0 + st[0] * res_x, y0 + st[1] * res_y] for st in tracks.values()]
        det_vel = [[st[3], st[2]] for st in tracks.values()]
        gt_pos, gt_vel = _flipped_truth(scene, pair + 1, dt_scene)
        acc.add(np.asarray(det_pos).reshape(-1, 2), np.asarray(det_vel).reshape(-1, 2),
                gt_pos, gt_vel, gt_in_region=_in_box(gt_pos, *rb[:4]))
    rep = acc.report()
    rep["pairs"] = summary["pairs"]
    rep["fps"] = n_frames / elapsed
    rep["oracle_agreement"] = oracle_agreement(out_dir, cfg, n_frames)
    return rep


def run(device: str | torch.device = "cuda", n_frames: int = N_FRAMES,
        names: list[str] | None = None) -> dict:
    """The benchmark's JSON record over the scenes named (all by default)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    chosen = dict(scenes())
    unknown = set(names or ()) - set(chosen)
    if unknown:
        raise ValueError(f"unknown scenes {sorted(unknown)}; known: {sorted(chosen)}")
    report: dict = {"n_frames": n_frames, "gate_m": GATE_M, "scenes": {},
                    "card": card_label(dev)}
    dt_scene = 1.0
    with tempfile.TemporaryDirectory() as tmp:
        for name, scene in chosen.items():
            if names and name not in names:
                continue
            log(f"=== scene {name}")
            seq_dir = os.path.join(tmp, name)
            paths = write_synthetic_sequence(scene, seq_dir, n_frames, dt=dt_scene)
            t0 = time.perf_counter()
            entry = {"gmfa": eval_gmfa(scene, paths, dt_scene, dev)}
            log(f"  gmfa: {entry['gmfa']}")
            entry["optical_flow"] = eval_pipeline_a(scene, paths, dt_scene, seq_dir, dev)
            log(f"  optical_flow: {entry['optical_flow']}")
            entry["wall_s"] = time.perf_counter() - t0
            report["scenes"][name] = entry
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--scenes", default=None, help="comma-separated scene names (default: all)")
    args = ap.parse_args()
    names = args.scenes.split(",") if args.scenes else None
    print(json.dumps(run("cuda", args.frames, names)))


if __name__ == "__main__":
    main()
