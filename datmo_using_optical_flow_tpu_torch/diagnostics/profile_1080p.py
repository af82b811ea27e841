"""Stage split of pipeline A's stream step, each stage synchronized.

The counterpart of the JAX package's ``benchmarks/profile_1080p.py``, with
``bench.py``'s configuration (``benchmarks.stream_1080p.config``: grid =
frame size at 0.1 m, 4096 cells, 32 clusters, 64 tracks; Farnebäck
0.3/5/15/5/5/5.0, ``fast_warp``).  Stages: the
whole stream step; ``flow_from_pyramids`` over all levels; K4 and K3 at the
finest level with the converged flow and with zero flow; the DATMO tail; the
flow of the levels below the finest; ``build_pyramid``.  Each row gives ms per
call (CUDA events, the stage ending in a synchronize), the device ms it keeps
the card busy (profiler) and their ratio.

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.profile_1080p [--height H --width W]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.benchmarks import stream_1080p
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label, stage_row
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA, _datmo_tail
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device


def run(frames: np.ndarray, device: str | torch.device = "cuda", reps: int = 5,
        max_cells: int = 4096) -> dict:
    """Rows for the first two of ``frames`` ((n, H, W) uint8 BEV grids)."""
    dev = resolve_device(device)
    card = card_label(dev)
    h, w = frames.shape[1:]
    cfg = stream_1080p.config(h, w, max_cells)
    c = cfg.farneback
    gaussian = bool(c.flags & fb.OPTFLOW_FARNEBACK_GAUSSIAN)
    pipe = PipelineA(cfg, dev, fast_warp=True)
    bev0, bev1 = (torch.as_tensor(np.asarray(f), device=dev) for f in frames[:2])
    primed, _ = pipe.step_stream(bev0, pipe.init_stream_carry())

    def pyramid(bev):
        return fb.build_pyramid(bev.to(torch.float32), c.pyr_scale, c.levels, c.poly_n,
                                c.poly_sigma)

    def flow(p1, p2):
        return fb.flow_from_pyramids(p1, p2, c.pyr_scale, c.winsize, c.iterations, True,
                                     gaussian)

    pyr1, pyr2 = pyramid(bev0), pyramid(bev1)
    f = flow(pyr1, pyr2)
    dx, dy = f[..., 0].contiguous(), f[..., 1].contiguous()
    zero = torch.zeros_like(dx)
    R0, R1 = pyr1[-1], pyr2[-1]
    valid = torch.ones((), dtype=torch.bool, device=dev)
    print(f"profile {h}x{w}: flow dx [{float(dx.min()):.2f}, {float(dx.max()):.2f}] "
          f"dy [{float(dy.min()):.2f}, {float(dy.max()):.2f}] [{card}]", flush=True)

    stages = [
        ("full stream step", lambda: pipe.step_stream(bev1, primed)),
        ("flow_from_pyramids (all levels)", lambda: flow(pyr1, pyr2)),
        ("K4 warp_matrices, finest level, real flow", lambda: fk.warp_matrices(R0, R1, dx, dy)),
        ("K4 warp_matrices, finest level, zero flow",
         lambda: fk.warp_matrices(R0, R1, zero, zero)),
        ("K3 fused_iteration, finest level, real flow",
         lambda: fk.fused_iteration(R0, R1, dx, dy, c.winsize, gaussian)),
        ("K3 fused_iteration, finest level, zero flow",
         lambda: fk.fused_iteration(R0, R1, zero, zero, c.winsize, gaussian)),
        ("DATMO tail (masks, DBSCAN, tracker)",
         lambda: _datmo_tail(f, valid, primed.step, cfg)),
        ("flow of the levels below the finest", lambda: flow(pyr1[:-1], pyr2[:-1])),
        ("build_pyramid (all levels)", lambda: pyramid(bev1)),
    ]
    rows = [stage_row(name, fn, dev, card, reps, launches=1) for name, fn in stages]
    return {"card": card, "device": str(dev), "shape": [h, w], "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    args = ap.parse_args()
    print(json.dumps(run(make_frames(2, args.height, args.width))))


if __name__ == "__main__":
    main()
