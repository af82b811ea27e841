"""Pipeline A's stream step at 1080x1920 on the card: the port's ``bench.py``.

``bench.py``'s workload and configuration: 25 ``make_frames(25, 1080, 1920)``
frames (seed 0), the grid set to the frame shape at 0.1 m, 4096 cells, 32
clusters, 64 tracks, Farnebäck 0.3/5/15/5/5/5.0 box, ``fast_warp``.  One
priming run, then ``sweeps`` sweeps (:func:`timed_sweep`): each primes a
fresh carry with frame 0 (synchronised, not timed), then times the 24 stream
steps after it on the host clock, ending in one synchronize.  Prints one JSON line, the JAX
package's ``{"metric": "end_to_end_datmo_fps_1080p_per_chip", "value",
"unit": "frames/s", "vs_baseline": fps / 30}``, with the card's name and
power limit.

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

METRIC = "end_to_end_datmo_fps_1080p_per_chip"
H, W = 1080, 1920


def config(h: int = H, w: int = W, max_cells: int = 4096) -> PipelineAConfig:
    """``bench.py``'s configuration: the grid set to the frame shape (``h`` x
    ``w``) at 0.1 m, 32 clusters, 64 tracks.  The diagnostics and chip_smoke
    take it at other frame shapes and cell capacities."""
    cfg = PipelineAConfig(x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1),
                          grid_resolution=(0.1, 0.1),
                          capacities=CapacityConfig(max_cells=max_cells, max_clusters=32,
                                                    max_tracks=64))
    assert cfg.grid_shape == (h, w), cfg.grid_shape
    return cfg


def timed_sweep(pipe: PipelineA, bevs: list[torch.Tensor]):
    """Prime a fresh carry with ``bevs[0]`` (synchronised, not timed), then
    step through ``bevs[1:]`` on the host clock, ending in one synchronize.
    Returns ``(seconds, carry, outputs)`` of the last step."""
    carry, _ = pipe.step_stream(bevs[0], pipe.init_stream_carry())
    torch.cuda.synchronize(pipe.device)
    t0 = time.perf_counter()
    for f in bevs[1:]:
        carry, out = pipe.step_stream(f, carry)
    torch.cuda.synchronize(pipe.device)
    return time.perf_counter() - t0, carry, out


def run(device: str | torch.device = "cuda", n_frames: int = 25, sweeps: int = 3) -> dict:
    """The benchmark's JSON record (``n_frames - 1`` timed steps per sweep)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    bevs = [torch.as_tensor(f, device=dev) for f in make_frames(n_frames, H, W)]
    pipe = PipelineA(config(), dev, fast_warp=True)

    t0 = time.perf_counter()
    carry, _ = pipe.step_stream(bevs[0], pipe.init_stream_carry())
    carry, out = pipe.step_stream(bevs[1], carry)
    torch.cuda.synchronize(dev)
    print(f"first run: {time.perf_counter() - t0:.2f} s; cells {int(out.cell_count)}",
          file=sys.stderr, flush=True)

    done, elapsed = 0, 0.0
    for _ in range(sweeps):
        seconds, carry, _ = timed_sweep(pipe, bevs)
        done += n_frames - 1
        elapsed += seconds
    fps = done / elapsed
    print(f"{done} steps in {elapsed:.3f} s ({elapsed / done * 1e3:.3f} ms/frame); final "
          f"tracks {int(carry.step.table.alive.sum())}", file=sys.stderr, flush=True)
    return {"metric": METRIC, "value": fps, "unit": "frames/s", "vs_baseline": fps / 30.0,
            "steps": done, "card": card_label(dev)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--sweeps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(run("cuda", args.frames, args.sweeps)))


if __name__ == "__main__":
    main()
