"""The quick sanity scene, both pipelines against its ground truth, on the
card: the port's ``examples/evaluate.py``.

One well-separated target (``center0 (5, -3)``, 2 x 1 m/frame; seed 11),
``num_frames`` PCD frames, the JAX script's small capacities (8192 raw, 2048
ROI points and cells, 8 clusters, 16 tracks).  GMFA (DBSCAN 1.0 / 30, ICP
0.1 m, 8192 moving points): per-frame detection precision and recall (3 m
gate) and the velocity error after frame 2 (``utils/metrics``); pipeline A:
pairs, live tracks and its runner's stage seconds.  Precision and recall
saturate near 1 by design; ``benchmarks/quality.py`` is the adversarial
surface.  Prints one JSON line with the card's name and power limit.

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.evaluate [num_frames]
"""

from __future__ import annotations

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
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              write_synthetic_sequence)
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device
from datmo_using_optical_flow_tpu_torch.utils.metrics import detection_pr, velocity_accuracy


def evaluate(n_frames: int, workdir: str, device: str | torch.device) -> dict:
    """The report of both pipelines over the sanity scene, on ``device``."""
    target = BoxTarget(center0=(5.0, -3.0, 0.75), velocity=(2.0, 1.0))
    scene = SyntheticScene(seed=11, targets=(target,))
    paths = write_synthetic_sequence(scene, os.path.join(workdir, "seq"), n_frames)
    gt_vel = np.asarray(target.velocity)
    caps = CapacityConfig(max_raw_points=8192, max_roi_points=2048,
                          max_cells=2048, max_clusters=8, max_tracks=16)
    report: dict = {}

    cfg_b = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30),
                       icp=IcpConfig(threshold=0.1), capacities=caps)
    pipe_b = GMFAPipeline(cfg_b, max_moving_points=8192, device=device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out_b = pipe_b.process_files(paths)
    elapsed_b = time.perf_counter() - t0
    prs, vels = [], []
    for row in out_b["rows"]:
        frame = row["Frame"]
        # the truth at frame f + 1 (a row of cloud i logs frame i - 1), x flipped
        t_pos = np.asarray(target.center0[:2]) + gt_vel * (frame + 1)
        t_pos = np.array([-t_pos[0], t_pos[1]])
        prs.append(detection_pr(np.array([[row["X"], row["Y"]]]), t_pos[None, :], gate=3.0))
        if frame >= 2:
            # GMFA's velocities are per cfg.dt (0.1 s); the scene moves per frame
            est = np.array([row["VX"], row["VY"]]) * cfg_b.dt
            vels.append(velocity_accuracy(est[None, :], np.array([[-gt_vel[0], gt_vel[1]]])))
    report["gmfa"] = {
        "frames": n_frames,
        "fps": len(out_b["rows"]) / max(elapsed_b, 1e-9),
        "detection_precision": float(np.mean([p["precision"] for p in prs])) if prs else None,
        "detection_recall": float(np.mean([p["recall"] for p in prs])) if prs else None,
        "velocity_mae_mps": float(np.mean([v["vel_mae"] for v in vels])) if vels else None,
    }

    pipe_a = PipelineA(PipelineAConfig(capacities=caps), device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out_a = pipe_a.process_files(paths, output_dir=os.path.join(workdir, "out_a"))
    elapsed_a = time.perf_counter() - t0
    report["optical_flow"] = {
        "pairs": out_a["pairs"],
        "fps": out_a["pairs"] / max(elapsed_a, 1e-9),
        "live_tracks": len(out_a["tracks"]),
        "stage_seconds": dict(out_a["timings"]),
    }
    return report


def run(device: str | torch.device = "cuda", n_frames: int = 6) -> dict:
    """The JSON record; refuses the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        report = evaluate(n_frames, tmp, dev)
    report["card"] = card_label(dev)
    return report


def main(argv: list[str]) -> int:
    print(json.dumps(run("cuda", int(argv[0]) if argv else 6)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
