"""End-point error of the batched 720p flow against its two references.

``benchmarks/flow_batched_720p`` holds the port's flow to the numpy model of
cv2 (``oracle/np_farneback.calc_flow``), since the card's machine has no
cv2.  This diagnostic splits that number: for each of the benchmark's 8
pairs (``make_frames(9, 720, 1280, seed=3)``, ``FarnebackConfig()``, the
kernel path's ``fast_warp``) it prints the largest EPE of the port's flow
against the numpy model, of the port's flow against cv2 and of the numpy
model against cv2, each over the whole grid and over the interior (the
``BORDER`` = 5 attenuated pixels left out), where cv2 imports.  No timing:
it runs where the caller says (``--device cpu`` here; on the card the
flows are the plain versions' bit for bit).

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.flow_accuracy --device cpu
        [--pairs K]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.benchmarks.flow_batched_720p import BATCH, H, W
from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
from datmo_using_optical_flow_tpu_torch.ops.farneback import farneback_flow
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import BORDER, calc_flow
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device


def epe_max(a: np.ndarray, b: np.ndarray) -> dict:
    """The largest end-point error over the grid and over its interior, with
    the pixel of the largest."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64), axis=-1)
    return {"max": float(d.max()), "interior_max": float(d[BORDER:-BORDER, BORDER:-BORDER].max()),
            "at": [int(i) for i in np.unravel_index(d.argmax(), d.shape)]}


def run(device: str | torch.device = "cuda", pairs: int = BATCH, h: int = H, w: int = W
        ) -> list[dict]:
    """One record per pair: the three EPEs (the cv2 ones only where cv2 imports)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    dev = resolve_device(device)
    cfg = FarnebackConfig()
    frames = make_frames(pairs + 1, h, w, seed=3).astype(np.float32)
    rows = []
    for i in range(pairs):
        a, b = frames[i], frames[i + 1]
        port = farneback_flow(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
                              cfg).cpu().numpy()
        model = calc_flow(a, b, cfg.pyr_scale, cfg.levels, cfg.winsize, cfg.iterations,
                          cfg.poly_n, cfg.poly_sigma)
        row = {"pair": i, "port_vs_model": epe_max(port, model)}
        if cv2 is not None:
            ref = cv2.calcOpticalFlowFarneback(a, b, None, cfg.pyr_scale, cfg.levels,
                                               cfg.winsize, cfg.iterations, cfg.poly_n,
                                               cfg.poly_sigma, 0)
            row.update(port_vs_cv2=epe_max(port, ref), model_vs_cv2=epe_max(model, ref))
        rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=BATCH)
    args = ap.parse_args()
    for row in run(args.device, args.pairs):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
