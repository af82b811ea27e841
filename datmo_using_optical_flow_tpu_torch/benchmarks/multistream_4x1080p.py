"""Four 1080p DATMO feeds served by one card: the port's
``benchmarks/bench_multistream.py`` (``BASELINE.json``'s 4x1080p
configuration in its single-chip form).

The JAX script's workload: 4 streams at 1080x1920 with ``bench.py``'s
configuration (``stream_1080p.config()``: 0.1 m grid, 4096 cells, 32
clusters, 64 tracks, Farnebäck 0.3/5/15/5/5/5.0 box, ``fast_warp``), each fed
9 ``make_frames`` frames (seeds 0-3), advanced together in stream mode
(:func:`parallel.streams.make_stream_mode_step`: each feed carries its
previous frame's coefficient pyramid).  One priming step on frame 0, then 3
repetitions of: re-prime with frame 0 (not timed), time frames 1-8 of every
feed on the host clock, synchronize.  Prints one JSON line, the JAX script's
``{"metric": "multistream_datmo_fps_4x1080p_single_chip", "value": aggregate
frames/s, "unit": "frames/s aggregate", "per_stream_fps"}``, with the card's
name and power limit.

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.multistream_4x1080p \
        [--frames N] [--reps R]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import H, W, config
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label
from datmo_using_optical_flow_tpu_torch.parallel import streams
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

METRIC = "multistream_datmo_fps_4x1080p_single_chip"
N_STREAMS = 4
N_FRAMES = 9
REPS = 3


def frames(dev: torch.device, n_streams: int = N_STREAMS, n_frames: int = N_FRAMES
           ) -> list[torch.Tensor]:
    """Per time step, the (n_streams, H, W) uint8 frames of every feed
    (feed ``s`` is ``make_frames(n_frames, H, W, seed=s)``)."""
    stacked = np.stack([make_frames(n_frames, H, W, seed=s) for s in range(n_streams)])
    return [torch.as_tensor(stacked[:, t], device=dev) for t in range(n_frames)]


def run(device: str | torch.device = "cuda", n_frames: int = N_FRAMES, reps: int = REPS
        ) -> dict:
    """The benchmark's JSON record."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    cfg = config()
    bevs = frames(dev, N_STREAMS, n_frames)
    step = streams.make_stream_mode_step(cfg, fast_warp=True, device=dev)

    t0 = time.perf_counter()
    carry, _, cells = step(bevs[0], streams.init_stream_mode_carry(cfg, N_STREAMS, dev))
    int(cells)
    print(f"first run (prime): {time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)

    done, elapsed = 0, 0.0
    for _ in range(reps):
        carry, _, cells = step(bevs[0], carry)  # re-prime (not timed)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for t in range(1, n_frames):
            carry, out, cells = step(bevs[t], carry)
            done += N_STREAMS
        torch.cuda.synchronize(dev)
        elapsed += time.perf_counter() - t0
    agg = done / elapsed
    print(f"{done} stream-frames in {elapsed:.3f} s ({elapsed / done * 1e3:.3f} ms per "
          f"stream-frame); cells {int(cells)}, per stream {out.cell_count.tolist()}; live "
          f"tracks {carry.step.table.alive.sum(dim=1).tolist()}", file=sys.stderr, flush=True)
    return {"metric": METRIC, "value": agg, "unit": "frames/s aggregate",
            "per_stream_fps": agg / N_STREAMS, "streams": N_STREAMS, "stream_frames": done,
            "ms_per_step": elapsed / (done / N_STREAMS) * 1e3, "cells": int(cells),
            "card": card_label(dev)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()
    print(json.dumps(run("cuda", args.frames, args.reps)))


if __name__ == "__main__":
    main()
