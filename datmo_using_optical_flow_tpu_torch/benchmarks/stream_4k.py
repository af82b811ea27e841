"""Pipeline A's stream step on a 4K grid (2176x3840) on the card: the port's
``benchmarks/diag_4k.py``.

The JAX script's workload: the grid set to 2176x3840 at 0.1 m with
``bench.py``'s capacities (``stream_1080p.config(2176, 3840)``: 4096 cells,
32 clusters, 64 tracks), 6 ``make_frames(6, 2176, 3840, seed=1,
n_objects=8)`` frames, ``fast_warp``.  The pyramid has four levels:
2176x3840, 653x1152 and 196x346 (K3 five times each) and 59x104 (K2), with
K1 on all four.  One priming run of ``scan_steps`` over frames 0-2
(synchronised), then ``reps`` runs over all frames from a fresh carry, each
ending in a read of its last cell count; frames/s is the pairs over their
host-clock time.  Unlike the JAX package, which takes its XLA path at widths
above 2048 (the TPU kernels' VMEM limit), the port runs its kernels at every
width, and K3 warps exactly on every level of at least 128x256 (README).
Prints one JSON line, the JAX script's ``{"metric": "datmo_4k_dispatch_fps",
"value", "unit": "frames/s", "grid", "stream_carry_mb"}``, with the card's
name and power limit.

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.stream_4k \
        [--frames N] [--reps R]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

METRIC = "datmo_4k_dispatch_fps"
H, W = 2176, 3840
N_FRAMES = 6
REPS = 2


def leaf_bytes(tree) -> int:
    """Bytes of every tensor in a nested tuple of tensors."""
    if isinstance(tree, tuple):
        return sum(leaf_bytes(t) for t in tree)
    return tree.numel() * tree.element_size()


def run(device: str | torch.device = "cuda", n_frames: int = N_FRAMES, reps: int = REPS
        ) -> dict:
    """The benchmark's JSON record (``reps * (n_frames - 1)`` timed pairs)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    pipe = PipelineA(config(H, W), dev, fast_warp=True)
    bevs = torch.as_tensor(make_frames(n_frames, H, W, seed=1, n_objects=8), device=dev)
    carry_mb = leaf_bytes(pipe.init_stream_carry()) / 1e6
    print(f"stream-carry residency at {H}x{W}: {carry_mb:.1f} MB", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    _, outs = pipe.scan_steps(bevs[:3], pipe.init_carry())
    int(outs.cell_count[-1])
    first_s = time.perf_counter() - t0
    print(f"first run (2 pairs): {first_s:.2f} s", file=sys.stderr, flush=True)

    done = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        _, outs = pipe.scan_steps(bevs, pipe.init_carry())
        int(outs.cell_count[-1])
        done += n_frames - 1
    elapsed = time.perf_counter() - t0
    fps = done / elapsed
    print(f"{done} pairs in {elapsed:.3f} s ({elapsed / done * 1e3:.3f} ms/pair); cells "
          f"{outs.cell_count.tolist()}", file=sys.stderr, flush=True)
    return {"metric": METRIC, "value": fps, "unit": "frames/s", "grid": f"{H}x{W}",
            "pairs": done, "first_run_s": first_s, "stream_carry_mb": carry_mb,
            "card": card_label(dev)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()
    print(json.dumps(run("cuda", args.frames, args.reps)))


if __name__ == "__main__":
    main()
