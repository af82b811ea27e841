"""GMFA (pipeline B) throughput at reference load on the card: the port's
``benchmarks/bench_gmfa.py``.

The JAX script's configuration and scene, nothing cut: ``max_raw_points=65536,
max_roi_points=10240`` (x10: 102,400 expanded points per cloud),
``max_cells=4096, max_clusters=32, max_tracks=64``, 16,384 moving points,
DBSCAN 5.0 / 1000, ICP 0.02 m / 30 rounds; a 40,000-point ground over 25 m,
one static box and three movers of 4,000 points each (seed 42), 7 frames
0.1 s apart.  Each frame is preprocessed by the port on the card (RANSAC
with 5000 hypotheses, ROI, densification x10) with the key
``fold_in(PRNGKey(0), i)``, as the JAX script keys it.  After one warm-up
(``seed_carry`` and one step), 3 sweeps of ``seed_carry`` and 6 steps are
timed on the host clock, each sweep ending in a synchronize; step i of sweep
r is keyed ``fold_in(PRNGKey(0), 100 + 10 r + i)``.  Only the steps are the
metric: the clouds are made before the clock starts.  Then the same frames,
written as binary PCD files, run through ``process_files`` (what ``run-b``
runs: decode, preprocess, step, track log) with float32 and with q16
points, after a 3-frame warm-up.

Prints one JSON line, the JAX script's ``{"metric":
"gmfa_fps_reference_load", "value", "unit": "frames/s", "expanded_points",
"vs_baseline": fps / 30}``, with the expanded and moving points per frame,
whether the moving-point cap was hit, K5's launches per step,
``preprocess`` synchronised with its device ms (and its RANSAC and jitter
alone, and a step's track-id draw, from the host key as the step draws it
and from a key on the card), and the file runner's frames/s with its
host ms per stage, beside the card's name and power limit.  The JAX script's stage
probes of the TPU have no counterpart here (``diagnostics/icp_body`` splits
the ICP round).

    python -m datmo_using_optical_flow_tpu_torch.benchmarks.gmfa_reference_load \
        [--frames N] [--sweeps S]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, GMFAConfig
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import card_label, stage_row
from datmo_using_optical_flow_tpu_torch.io.frames import pad_points
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline, new_track_ids
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.ops import points as point_ops
from datmo_using_optical_flow_tpu_torch.ops.ransac import remove_ground
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              synthetic_frame,
                                                              write_synthetic_sequence)
from datmo_using_optical_flow_tpu_torch.utils import prng
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

METRIC = "gmfa_fps_reference_load"
N_FRAMES = 7
SWEEPS = 3
MAX_MOVING = 16384


def config() -> GMFAConfig:
    """``bench_gmfa.py:52-55``: GMFA's defaults (DBSCAN 5.0 / 1000, ICP 0.02 m
    / 30 rounds, RANSAC 0.5 m / 5 / 5000) at 102,400 expanded points."""
    return GMFAConfig(capacities=CapacityConfig(max_raw_points=65536, max_roi_points=10240,
                                                max_cells=4096, max_clusters=32,
                                                max_tracks=64))


def scene() -> SyntheticScene:
    """``bench_gmfa.py:57-68``: CARLA-like density, ~56,000 raw points."""
    return SyntheticScene(
        ground_points=40000, ground_extent=25.0,
        static_boxes=(BoxTarget(center0=(-8.0, 6.0, 1.0), velocity=(0, 0),
                                points_per_frame=4000),),
        targets=(BoxTarget(center0=(6.0, -4.0, 0.75), velocity=(1.5, 0.8),
                           points_per_frame=4000),
                 BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2),
                           size=(3.0, 1.6, 1.4), points_per_frame=4000),
                 BoxTarget(center0=(0.0, 10.0, 0.75), velocity=(0.5, -1.5),
                           points_per_frame=4000)),
        seed=42)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def raw_frames(cfg: GMFAConfig, scn: SyntheticScene, n_frames: int
               ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Frames 0..n_frames-1, ``cfg.dt`` apart, padded to ``max_raw_points``."""
    return [pad_points(synthetic_frame(scn, i, dt=cfg.dt).astype(np.float32),
                       cfg.capacities.max_raw_points) for i in range(n_frames)]


def frame_key(i: int, dev) -> torch.Tensor:
    """Frame i's preprocessing key, ``fold_in(PRNGKey(0), i)``."""
    return prng.fold_in(prng.PRNGKey(0), i).to(dev)


def clouds(pipe: GMFAPipeline, frames) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each padded frame preprocessed by ``pipe`` on its device."""
    dev = pipe.device
    return [pipe.preprocess(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev),
                            frame_key(i, dev)) for i, (p, m) in enumerate(frames)]


def timed_sweeps(pipe: GMFAPipeline, cl, sweeps: int):
    """``sweeps`` runs of ``seed_carry`` then one step per later cloud, on the
    host clock, each ending in a synchronize.  Returns ``(seconds, steps,
    carry, outputs of the last sweep)``."""
    dev = pipe.device
    keys = [{i: prng.fold_in(prng.PRNGKey(0), 100 + r * 10 + i) for i in range(1, len(cl))}
            for r in range(sweeps)]
    steps, outs = 0, []
    t0 = time.perf_counter()
    for r in range(sweeps):
        carry = pipe.seed_carry(*cl[0])
        outs = []
        for i in range(1, len(cl)):
            carry, out = pipe.step(*cl[i], carry, keys[r][i])
            outs.append(out)
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, steps, carry, outs


def timed_runner(pipe: GMFAPipeline, paths: list[str], q16: bool) -> dict:
    """``process_files`` over ``paths`` (what ``run-b`` runs) on the host
    clock, after a 3-frame warm-up run: frames/s and the runner's host ms
    per frame by stage."""
    pipe.process_files(paths[:3], h2d_q16=q16)
    t0 = time.perf_counter()
    summary = pipe.process_files(paths, h2d_q16=q16)
    elapsed = time.perf_counter() - t0
    n = len(paths)
    return {"fps": n / elapsed, "rows": len(summary["rows"]),
            "host_ms_per_frame": {k: v / n * 1e3 for k, v in summary["timings"].items()}}


def measure(pipe: GMFAPipeline, frames, paths: list[str], sweeps: int, card: str) -> dict:
    """The benchmark's record for ``pipe`` on ``frames`` (padded numpy
    points) and the same frames as PCD files ``paths``: preprocess, warm up,
    time the sweeps, the preprocess stage rows on frame 2 (or the last),
    then the file runner with float32 and q16 points."""
    dev, c = pipe.device, pipe.cfg
    t0 = time.perf_counter()
    cl = clouds(pipe, frames)
    expanded = [int(m.sum()) for _, m in cl]
    log(f"{len(cl)} frames preprocessed in {time.perf_counter() - t0:.2f} s; expanded points "
        f"per cloud {expanded} (capacity {c.capacities.max_expanded_points})")

    t0 = time.perf_counter()
    carry, out = pipe.step(*cl[1], pipe.seed_carry(*cl[0]), prng.PRNGKey(0))
    log(f"first run: {time.perf_counter() - t0:.2f} s; moving {int(out.moving_count)}, "
        f"clusters {int(out.n_clusters)}")

    nn_kernels.reset_launches()
    elapsed, steps, carry, outs = timed_sweeps(pipe, cl, sweeps)
    k5 = nn_kernels.LAUNCHES["nearest_neighbors"]
    fps = steps / elapsed
    moving = [int(o.moving_count) for o in outs]
    cap_hit = [m >= pipe.max_moving for m in moving]
    log(f"{steps} steps in {elapsed:.3f} s ({elapsed / steps * 1e3:.3f} ms/frame, {fps:.3f} "
        f"frames/s); moving points per step {moving} (cap {pipe.max_moving}, hit {cap_hit}); "
        f"clusters {[int(o.n_clusters) for o in outs]}; K5 launches {k5 / steps:.1f} per step; "
        f"live tracks {int(carry.table.alive.sum())} [{card}]")

    f = min(2, len(frames) - 1)
    P, M = (torch.from_numpy(a).to(dev) for a in frames[f])
    host_key = prng.fold_in(prng.PRNGKey(0), f)
    key = host_key.to(dev)
    kr, kd = prng.split(key)
    r = c.ransac
    flipped = point_ops.flip_x(P)
    with contextlib.redirect_stdout(sys.stderr):
        rows = [stage_row(name, fn, dev, card) for name, fn in (
            ("preprocess (whole)", lambda: pipe.preprocess(P, M, key)),
            ("  RANSAC remove_ground", lambda: remove_ground(
                flipped, M, kr, r.distance_threshold, r.ransac_n, r.num_iterations)),
            ("  densify jitter (prng.normal_fma)",
             lambda: prng.normal_fma(kd, cl[f][0], c.noise_std)),
            ("track-id draw of a step (host key, one copy)",
             lambda: new_track_ids(host_key, c.capacities.max_clusters, dev)),
            ("  the same draw from a key on the card",
             lambda: prng.randint(key, (c.capacities.max_clusters,), 0, 100000)))]
    runner = {q16: timed_runner(pipe, paths, q16) for q16 in (False, True)}
    log(f"process_files over {len(paths)} PCD files: {runner[False]} float32, {runner[True]} "
        f"q16 [{card}]")
    return {"metric": METRIC, "value": fps, "unit": "frames/s", "expanded_points": expanded[0],
            "vs_baseline": fps / 30.0, "ms_per_frame": elapsed / steps * 1e3, "steps": steps,
            "frames": len(frames), "sweeps": sweeps, "expanded_points_per_frame": expanded,
            "moving_points_per_step": moving, "moving_cap": pipe.max_moving,
            "moving_cap_hit": cap_hit, "k5_launches_per_step": k5 / steps,
            "stages": rows, "runner_fps": runner[False]["fps"],
            "runner_fps_q16": runner[True]["fps"],
            "runner_host_ms_per_frame": runner[False]["host_ms_per_frame"],
            "runner_host_ms_per_frame_q16": runner[True]["host_ms_per_frame"], "card": card}


def run(device: str | torch.device = "cuda", n_frames: int = N_FRAMES,
        sweeps: int = SWEEPS) -> dict:
    """The benchmark's JSON record on the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; pass a CUDA device")
    card = card_label(dev)
    cfg = config()
    pipe = GMFAPipeline(cfg, max_moving_points=MAX_MOVING, device=dev)
    # the runner's prints go to stderr: stdout is the JSON line
    with contextlib.redirect_stdout(sys.stderr), tempfile.TemporaryDirectory() as tmp:
        paths = write_synthetic_sequence(scene(), tmp, n_frames, dt=cfg.dt)
        return measure(pipe, raw_frames(cfg, scene(), n_frames), paths, sweeps, card)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    args = ap.parse_args()
    print(json.dumps(run("cuda", args.frames, args.sweeps)))


if __name__ == "__main__":
    main()
