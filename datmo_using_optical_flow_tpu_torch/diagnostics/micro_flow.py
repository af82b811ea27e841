"""Micro-profile of the flow kernels at the full-size level with real flow.

The counterpart of the JAX package's ``benchmarks/micro_flow.py``.  The two
frames' pyramids and their converged flow come from the port's
``build_pyramid`` and ``flow_from_pyramids`` (the pipeline's configuration;
the number of distinct displacements matters to the warp).  At the finest
level it times K3 (one fused iteration), K4 (the standalone warp and M), K2 on
K4's M, the packed-gather ``update_matrices`` (plain PyTorch, for reference)
and K1 at the two finest levels.  Each row gives ms per call, device µs, the
bytes and operations of the work, its bound on the H100 and the share of the
bound reached (``roofline``).

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow [--height H --width W]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import (card_label, kernel_row,
                                                                     moving_frames)
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device


def run(frames: np.ndarray, device: str | torch.device = "cuda", reps: int = 20) -> dict:
    """Rows for the first two of ``frames`` ((n, H, W) uint8 BEV grids)."""
    dev = resolve_device(device)
    card = card_label(dev)
    c = FarnebackConfig()
    gaussian = bool(c.flags & fb.OPTFLOW_FARNEBACK_GAUSSIAN)
    im1, im2 = (torch.as_tensor(np.asarray(f), device=dev).to(torch.float32) for f in frames[:2])
    pyr1, pyr2 = (fb.build_pyramid(im, c.pyr_scale, c.levels, c.poly_n, c.poly_sigma)
                  for im in (im1, im2))
    flow = fb.flow_from_pyramids(pyr1, pyr2, c.pyr_scale, c.winsize, c.iterations, True,
                                 gaussian)
    dx, dy = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    R0, R1 = pyr1[-1], pyr2[-1]
    _, h, w = R0.shape
    M = fk.warp_matrices(R0, R1, dx, dy)
    packed = fb.pack_corner_pairs(R1)
    print(f"micro_flow {h}x{w}: flow dx [{float(dx.min()):.2f}, {float(dx.max()):.2f}] "
          f"dy [{float(dy.min()):.2f}, {float(dy.max()):.2f}] [{card}]", flush=True)

    win = c.winsize
    rows = [
        kernel_row(f"K3 fused_iteration {h}x{w}", lambda: fk.fused_iteration(
            R0, R1, dx, dy, win, gaussian), roofline.fused_iteration(h, w, win), dev, card, reps),
        kernel_row(f"K4 warp_matrices {h}x{w}", lambda: fk.warp_matrices(R0, R1, dx, dy),
                   roofline.warp_matrices(h, w), dev, card, reps),
        kernel_row(f"K2 blur_solve on K4's M {h}x{w}", lambda: fk.blur_solve(M, win, gaussian),
                   roofline.blur_solve(h, w, win), dev, card, reps),
        kernel_row(f"update_matrices packed (plain) {h}x{w}", lambda: fb.update_matrices(
            R0, R1, dx, dy, packed), roofline.update_matrices_packed(h, w), dev, card, reps),
    ]
    # K1 on the two finest levels' images, as build_pyramid feeds it
    for _, scale, lh, lw in level_sizes(h, w, c.pyr_scale, c.levels)[::-1][:2]:
        img = fb.level_image(im1, scale, lh, lw)
        rows.append(kernel_row(f"K1 poly_exp {lh}x{lw}", lambda img=img: fk.poly_exp(
            img, c.poly_n, c.poly_sigma), roofline.poly_exp(lh, lw, c.poly_n, c.poly_sigma),
            dev, card, reps))
    return {"card": card, "device": str(dev), "shape": [h, w], "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    args = ap.parse_args()
    print(json.dumps(run(moving_frames(2, args.height, args.width))))


if __name__ == "__main__":
    main()
