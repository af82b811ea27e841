"""Batched dense flow, 8 frame pairs at 720p, on the card: the port's
``benchmarks/bench_flow_batched.py`` (``BASELINE.json``'s config[1]).

The JAX script's workload: 9 ``make_frames(9, 720, 1280, seed=3)`` frames,
the 8 consecutive pairs, ``FarnebackConfig()`` (0.3/5/15/5/5/5.0 box), the
kernel path (``fast_warp``: the packed warp below 128x256, as the JAX kernel
path packs there).  :func:`ops.farneback.farneback_flow_batched` runs the
pairs one after another on the card.  One untimed run, whose flows are held
to the numpy model of cv2 (``oracle/np_farneback.calc_flow``) by their
largest end-point error, then ``reps`` runs timed together on the host clock
with one synchronize at the end.  The JAX script takes its EPE against cv2
itself; the card's machine has no cv2, and the numpy model is pinned to
cv2 at < 1e-3 px EPE on the JAX package's small test pair (a deliberate
difference, README).  On these 720p pairs the model itself is up to
``MODEL_VS_CV2_PX`` from cv2, on the bottom border row, while the port's
flow is within ``PORT_VS_CV2_PX`` of cv2 on every pair (both held by
``tests/test_torch_flow_batched_720p.py``; the kernels equal the plain
path bit for bit): an ``epe_max_px`` over the budget is the reference's
distance, and the record names that distance beside
``epe_within_budget``.
Prints one JSON line, the JAX script's ``{"metric":
"batched_farneback_fps_720p_x8", "value", "unit": "frames/s", "epe_max_px",
"epe_budget_px": 0.1}``, with the card's name and power limit.

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.flow_batched_720p [--reps R]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label
from datmo_using_optical_flow_tpu_torch.ops.farneback import farneback_flow_batched
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import calc_flow
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

METRIC = "batched_farneback_fps_720p_x8"
H, W, BATCH = 720, 1280, 8
REPS = 3
EPE_BUDGET_PX = 0.1
# The largest EPE over the 8 pairs of the numpy model against cv2 and of the
# port's flow (its plain path) against cv2, on a host with cv2
# (``diagnostics/flow_accuracy``); the slow test holds both.
MODEL_VS_CV2_PX = 0.1207
PORT_VS_CV2_PX = 0.0183


def oracle_epe_max(frames: np.ndarray, flows: np.ndarray, cfg: FarnebackConfig,
                   pairs: int) -> float:
    """The largest end-point error of ``flows[i]`` against ``calc_flow`` of
    frames ``i, i + 1`` over the first ``pairs`` pairs."""
    worst = 0.0
    for i in range(pairs):
        ref = calc_flow(frames[i].astype(np.float32), frames[i + 1].astype(np.float32),
                        cfg.pyr_scale, cfg.levels, cfg.winsize, cfg.iterations, cfg.poly_n,
                        cfg.poly_sigma)
        worst = max(worst, float(np.linalg.norm(flows[i] - ref, axis=-1).max()))
    return worst


def run(device: str | torch.device = "cuda", reps: int = REPS,
        epe_pairs: int = BATCH) -> dict:
    """The benchmark's JSON record; the EPE over the first ``epe_pairs``
    pairs (all 8 from the command line)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    cfg = FarnebackConfig()
    frames = make_frames(BATCH + 1, H, W, seed=3)
    im1 = torch.as_tensor(frames[:BATCH].astype(np.float32), device=dev)
    im2 = torch.as_tensor(frames[1:].astype(np.float32), device=dev)

    t0 = time.perf_counter()
    flows = farneback_flow_batched(im1, im2, cfg).cpu().numpy()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epe_max = oracle_epe_max(frames, flows, cfg, epe_pairs)
    within = epe_max <= EPE_BUDGET_PX
    print(f"first run: {first_s:.2f} s; max EPE vs the numpy model of cv2 over "
          f"{epe_pairs} pairs: {epe_max:.5f} px ({time.perf_counter() - t0:.1f} s)"
          + ("" if within else f", over the {EPE_BUDGET_PX} px budget: the model itself is up "
             f"to {MODEL_VS_CV2_PX} px from cv2 on these pairs, the port's flow within "
             f"{PORT_VS_CV2_PX}"), file=sys.stderr, flush=True)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = farneback_flow_batched(im1, im2, cfg)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    fps = BATCH * reps / elapsed
    print(f"{BATCH * reps} pairs in {elapsed:.3f} s ({elapsed / (BATCH * reps) * 1e3:.3f} "
          f"ms per pair); flow finite: {bool(torch.isfinite(out).all())}",
          file=sys.stderr, flush=True)
    return {"metric": METRIC, "value": fps, "unit": "frames/s", "epe_max_px": epe_max,
            "epe_budget_px": EPE_BUDGET_PX, "epe_within_budget": within, "epe_pairs": epe_pairs,
            "epe_reference": "oracle/np_farneback.calc_flow",
            "epe_reference_vs_cv2_px": MODEL_VS_CV2_PX,
            "first_run_s": first_s,
            "card": card_label(dev)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()
    print(json.dumps(run("cuda", args.reps)))


if __name__ == "__main__":
    main()
