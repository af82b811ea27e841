"""The fixed cost of one cached ICP round, split into its parts.

The counterpart of the JAX package's ``benchmarks/diag_icp_body.py``.  Each
part runs ``steps`` times in a Python loop, as ICP's rounds do, and is timed
in total and per step (CUDA events around the loop, which ends in a
synchronize; the best of ``reps`` runs), with the device ms it keeps the card
busy:

* the carry arithmetic alone (two small ops: the floor a round's ops stand on);
* ``ops/icp._kabsch`` with its host SVD, on fixed correspondences;
* Kabsch's fixed-tree sums without the host copy (``_kabsch_sums``);
* the cached round's algebra without K5 (``_eval_cached`` with a sweep that
  returns fixed values and launches nothing);
* the stable partition of the active query and its un-permuting gathers
  (``ops/nn.partition_active`` / ``unpartition``), the active set flipping
  every step;
* one K6 launch (``ops/probe_kernels.tiny`` on an (8, 128) block).

A probe the JAX records never had: the tiles K5 visits per 256-row block in
ICP's first round (every valid row active) and in its active round with the
most rows, read from the plain sweep's stopping rule
(``ops/nn_kernels.nearest_neighbors_reference_visits``) on the inputs the
round gave K5.  It changes no output of the kernel: ICP runs as it does in the
pipeline, with a recorder around its active query.

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.icp_body [--points N]
"""

from __future__ import annotations

import argparse
import json
import time
from unittest import mock

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import (card_label,
                                                                     device_us_per_call, fmt, sync)
from datmo_using_optical_flow_tpu_torch.ops import icp
from datmo_using_optical_flow_tpu_torch.ops import nn
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.ops import probe_kernels
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device


def _loop_row(name: str, body, steps: int, dev: torch.device, card: str, reps: int) -> dict:
    """Best total ms of ``steps`` calls of ``body(i)`` over ``reps`` runs."""
    def loop():
        for i in range(steps):
            body(i)

    loop()  # warm-up
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            loop()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    us = device_us_per_call(loop, dev, reps=1)
    dev_ms = None if us is None else us / 1e3
    row = {"name": name, "ms_total": best, "ms_per_step": best / steps, "steps": steps,
           "device_ms_total": dev_ms}
    print(f"{name:52s} {best:9.3f} ms total {best / steps:8.4f} ms/step, device "
          f"{fmt(dev_ms)} ms [{card}]", flush=True)
    return row


def tile_visits(pts: torch.Tensor, active: torch.Tensor, index: nn_kernels.TargetIndex,
                cap2) -> dict:
    """Tiles K5 visits per live 256-row block for one active query, as
    ``ops/nn.nearest_neighbors_active`` gives it to the sweep, and the
    sweep's work for those visits."""
    src_c, _, n_active = nn.partition_active(pts.to(torch.float32), active)
    _, visits = nn_kernels.nearest_neighbors_reference_visits(src_c, index, n_active, cap2)
    n_act = int(n_active)
    live = visits[:-(-n_act // nn_kernels.SRC_BLOCK)].to(torch.float64)
    total = int(live.sum())
    work = roofline.nearest_neighbors(pts.shape[0], index.packed.shape[0] * nn_kernels.TGT_TILE,
                                      total, live.numel())
    return {"active_rows": n_act, "live_blocks": live.numel(),
            "tiles": index.packed.shape[0], "visits_total": total,
            "visits_mean": float(live.mean()) if live.numel() else 0.0,
            "visits_median": float(live.median()) if live.numel() else 0.0,
            "visits_max": int(live.max()) if live.numel() else 0,
            "bytes": work.bytes, "ops": work.ops, "bound_us": work.bound_us(),
            "bound_by": work.bound_by()}


def _probe_pair(src: torch.Tensor):
    """A target for the probe: ``src`` turned by 0.2 degrees about z and moved
    by (5, -3, 0) cm."""
    a = np.deg2rad(0.2)
    rot = torch.tensor([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                        [0.0, 0.0, 1.0]], dtype=torch.float32, device=src.device)
    shift = torch.tensor([0.05, -0.03, 0.0], device=src.device)
    mask = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    return src, mask, (src @ rot.T + shift).contiguous(), mask


def icp_tile_probe(source, source_mask, target, target_mask, threshold: float,
                   max_iterations: int, card: str) -> dict:
    """Run cached ICP as GMFA does and read the tiles K5 visits in the first
    round and in the active round with the most rows."""
    rounds = []
    original = icp.nearest_neighbors_active

    def recorder(pts, tgt, tgt_mask, active, index=None, cap2=None):
        rounds.append((pts.clone(), active.clone(), index, cap2))
        return original(pts, tgt, tgt_mask, active, index=index, cap2=cap2)

    with mock.patch.object(icp, "nearest_neighbors_active", recorder):
        res = icp.registration_icp(source, source_mask, target, target_mask, threshold,
                                   max_iterations, cached=True)
    active_counts = [int(r[1].sum()) for r in rounds]
    later = [i for i in range(1, len(rounds)) if active_counts[i] > 0]
    busiest = max(later, key=lambda i: active_counts[i]) if later else None
    out = {"iterations": int(res.iterations), "fitness": float(res.fitness),
           "active_rows_per_round": active_counts, "rounds": {}}
    for label, i in (("first", 0), ("active", busiest)):
        if i is None:
            continue
        pts, active, index, cap2 = rounds[i]
        v = tile_visits(pts, active, index, cap2)
        v["round"] = i
        out["rounds"][label] = v
        print(f"K5 tiles per block, ICP {label} round ({i}): {v['active_rows']} active rows, "
              f"{v['live_blocks']} live blocks of {-(-pts.shape[0] // nn_kernels.SRC_BLOCK)}, "
              f"visits mean {v['visits_mean']:.2f} median {v['visits_median']:.1f} max "
              f"{v['visits_max']} of {v['tiles']} tiles, {v['ops'] / 1e9:.3f} Gop, bound "
              f"{v['bound_us']:.3f} us ({v['bound_by']}) [{card}]", flush=True)
    print(f"ICP probe: {out['iterations']} rounds ran, fitness {out['fitness']:.6f}, active "
          f"rows per round {active_counts} [{card}]", flush=True)
    return out


def run(src, dst, weights, device: str | torch.device = "cuda", steps: int = 30,
        reps: int = 3, probe=None, threshold: float = 0.02, max_iterations: int = 30) -> dict:
    """Rows for the (N, 3) clouds ``src``, ``dst`` and (N,) ``weights``;
    ``probe`` = (source, source_mask, target, target_mask) for the tile probe
    (default: ``src`` against itself turned and moved a little)."""
    dev = resolve_device(device)
    card = card_label(dev)
    s = torch.as_tensor(np.asarray(src, np.float32), device=dev)
    d = torch.as_tensor(np.asarray(dst, np.float32), device=dev)
    wgt = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    n = s.shape[0]
    state = {}

    def carry(i):
        state["acc"] = state.get("acc", torch.zeros((), device=dev)) * 1.0000001 + 1.0

    def kabsch(i):
        state["t"] = icp._kabsch(s, d, wgt) @ state.get("t", torch.eye(4, device=dev))

    def kabsch_sums(i):
        icp._kabsch_sums(s, d, wgt)

    # the cached round without K5: a sweep that hands back fixed values
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    fixed = (torch.zeros(n, dtype=torch.int32, device=dev), torch.abs(s[:, 0]) * 0.1,
             torch.abs(s[:, 0]) * 0.1, torch.abs(s[:, 1]) * 0.2, d)
    live = torch.ones((), dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)
    thr2 = float(np.float32(threshold * threshold))

    def cached_algebra(i):
        cache = state.get("cache", (fixed[1], d, s, fixed[3]))
        state["cache"] = icp._eval_cached(s, mask, d, mask, thr2, eye, cache, live, None,
                                          None, lambda *a, **k: fixed)[4]

    active0 = wgt > 0.5

    def partition(i):
        active = active0 ^ (i % 2 == 1)
        _, pos, _ = nn.partition_active(s, active)
        nn.unpartition(fixed, pos, active)

    x = torch.zeros((8, 128), device=dev)

    def tiny(i):
        state["x"] = probe_kernels.tiny(state.get("x", x))

    parts = [("carry arithmetic only", carry),
             ("kabsch + host SVD (fixed correspondences)", kabsch),
             ("kabsch tree sums only (no host copy)", kabsch_sums),
             ("eval_cached algebra (no K5)", cached_algebra),
             ("stable partition + scatter + gathers", partition),
             ("one K6 launch (tiny) per step", tiny)]
    rows = [_loop_row(name, body, steps, dev, card, reps) for name, body in parts]
    if probe is None:
        probe = _probe_pair(s)
    tiles = icp_tile_probe(*(torch.as_tensor(t, device=dev) for t in probe), threshold,
                           max_iterations, card)
    return {"card": card, "device": str(dev), "points": n, "steps": steps, "rows": rows,
            "tile_probe": tiles}


def clouds(n: int, seed: int = 0):
    """The JAX script's clouds: two uniform(-20, 20) clouds and 1% weights."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    dst = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    w = (rng.uniform(0, 1, (n,)) < 0.01).astype(np.float32)
    return src, dst, w


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=102400)
    args = ap.parse_args()
    print(json.dumps(run(*clouds(args.points), threshold=0.2)))


if __name__ == "__main__":
    main()
