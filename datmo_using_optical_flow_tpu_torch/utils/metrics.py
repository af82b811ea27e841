"""Evaluation metrics: flow EPE, velocity accuracy, detection precision and
recall, an FPS meter and a per-frame metrics log.

A verbatim copy of ``datmo_using_optical_flow_tpu.utils.metrics`` (numpy
only), so that the port's quality benchmarks import nothing of the JAX
package; ``tests/test_torch_boundary.py`` holds it to the original line for
line.  ``README.md:8`` of the reference lists "velocity estimation accuracy,
detection precision, recall, and computational efficiency" with no code for
them; the flow-EPE criterion is BASELINE.json's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


def flow_epe(flow: np.ndarray, reference_flow: np.ndarray) -> dict:
    """End-point error stats vs a reference flow field (BASELINE: mean <= 0.1 px)."""
    d = np.linalg.norm(np.asarray(flow, np.float64) - np.asarray(reference_flow, np.float64),
                       axis=-1)
    return {"epe_mean": float(d.mean()), "epe_max": float(d.max()),
            "epe_p99": float(np.percentile(d, 99))}


def velocity_accuracy(estimated: np.ndarray, ground_truth: np.ndarray) -> dict:
    """Velocity-vector accuracy for matched tracks: (N, 2) est vs (N, 2) truth."""
    est = np.atleast_2d(np.asarray(estimated, np.float64))
    gt = np.atleast_2d(np.asarray(ground_truth, np.float64))
    err = np.linalg.norm(est - gt, axis=1)
    mag_err = np.abs(np.linalg.norm(est, axis=1) - np.linalg.norm(gt, axis=1))
    return {"vel_rmse": float(np.sqrt((err ** 2).mean())) if len(err) else 0.0,
            "vel_mae": float(err.mean()) if len(err) else 0.0,
            "speed_mae": float(mag_err.mean()) if len(mag_err) else 0.0}


def detection_pr(detections: np.ndarray, truths: np.ndarray, gate: float = 2.0) -> dict:
    """Precision/recall of detected object positions vs ground truth.

    Greedy nearest matching within ``gate`` meters; each truth matches at most
    one detection.  Positions are (N, 2)/(M, 2) arrays.
    """
    det = np.atleast_2d(np.asarray(detections, np.float64)).reshape(-1, 2)
    gt = np.atleast_2d(np.asarray(truths, np.float64)).reshape(-1, 2)
    matched_det: set[int] = set()
    tp = 0
    for t in gt:
        if det.shape[0] == 0:
            break
        d = np.linalg.norm(det - t, axis=1)
        d[list(matched_det)] = np.inf
        j = int(np.argmin(d))
        if d[j] <= gate:
            matched_det.add(j)
            tp += 1
    fp = det.shape[0] - len(matched_det)
    fn = gt.shape[0] - tp
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {"tp": tp, "fp": fp, "fn": fn, "precision": precision, "recall": recall}


@dataclass
class FpsCounter:
    """Live FPS meter like the simulator's (``single_target_simultion.py:356-360``)."""

    window: float = 1.0
    _t_last: float = field(default_factory=time.time)
    _frames: int = 0
    fps: float = 0.0

    def tick(self, n: int = 1) -> float | None:
        """Count frames; returns the FPS once per window, else None."""
        self._frames += n
        now = time.time()
        if now - self._t_last >= self.window:
            self.fps = self._frames / (now - self._t_last)
            self._t_last = now
            self._frames = 0
            return self.fps
        return None


class MetricsLog:
    """Append-only structured per-frame metrics (CSV/JSONL)."""

    def __init__(self, path: str):
        self.path = path
        self._rows: list[dict] = []

    def append(self, frame: int, **metrics) -> None:
        self._rows.append({"frame": frame, **metrics})

    def flush(self) -> None:
        import json

        with open(self.path, "w") as f:
            for row in self._rows:
                f.write(json.dumps(row) + "\n")
