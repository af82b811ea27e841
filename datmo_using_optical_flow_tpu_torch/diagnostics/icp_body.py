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
round gave K5, with the busiest block's index beside the last live block's
(the one that mixes the last active rows with the first inactive ones).  It
changes no output of the kernel: ICP runs as it does in the pipeline, with a
recorder around its active query (:func:`record_icp_rounds`, which also gives
the rounds' K5 inputs to ``chip_smoke.py``).

With ``--parent DIR``, an older checkout of the repo (``git archive <rev> |
tar -x -C build/parent``, say), that checkout's ``ops/icp.py`` is loaded as a
module of its own (its imports resolve to this package), and three parts are
timed for both in turns (the parent, this code twice, the parent; the best of
each): ``transform_points`` on the clouds, the cached round's algebra without
K5, and one cached ``registration_icp`` on the probe's pair.

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.icp_body [--points N] [--parent DIR]

With ``--sweeps`` it runs only :func:`sweep_ab` on frames 0 -> 1 of GMFA's
reference load (``diagnostics/icp_sound.reference_clouds``) and prints its
record: chip_smoke runs it in a process of its own, where the profiler keeps
its traces.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import (LostTrace, card_label,
                                                                     device_us_per_call, fmt,
                                                                     ms_per_call, sync)
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


def tile_visits(p: nn_kernels.Prepared) -> dict:
    """Tiles K5 visits per live 256-row block (one with an active row) for
    the sweep inputs ``p`` (:func:`round_inputs`), and the sweep's work for
    those visits.  Blocks are numbered in the swept order."""
    index = p.index
    _, visits = nn_kernels._sweep_reference(p)
    blocks = torch.nonzero(p.block_counts > 0)[:, 0]
    live = visits[blocks].to(torch.float64)
    total = int(live.sum())
    work = roofline.nearest_neighbors(p.src.shape[0], index.packed.shape[0] * nn_kernels.TGT_TILE,
                                      total, live.numel())
    vmax = int(live.max()) if live.numel() else 0
    return {"active_rows": int(p.block_counts.sum()), "live_blocks": live.numel(),
            "tiles": index.packed.shape[0], "visits_total": total,
            "visits_mean": float(live.mean()) if live.numel() else 0.0,
            "visits_median": float(live.median()) if live.numel() else 0.0,
            "visits_max": vmax,
            "busiest_block": int(blocks[torch.argmax(live)]) if live.numel() else -1,
            "last_live_block": int(blocks[-1]) if live.numel() else -1,
            "bytes": work.bytes, "ops": work.ops, "bound_us": work.bound_us(),
            "bound_by": work.bound_by(),
            "serial_bound_us": roofline.nearest_neighbors_serial_us(vmax)}


def sweeps_bound_us(calls: list) -> float:
    """The least time of the K5 launches ``calls`` (``(prepared, active)``
    pairs, as :func:`_k5_calls` records them) on the H100: the sum of each
    launch's bound for the tiles its live blocks visit (:func:`tile_visits`)."""
    return sum(tile_visits(p)["bound_us"] for p, _ in calls)


def _probe_pair(src: torch.Tensor):
    """A target for the probe: ``src`` turned by 0.2 degrees about z and moved
    by (5, -3, 0) cm."""
    a = np.deg2rad(0.2)
    rot = torch.tensor([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                        [0.0, 0.0, 1.0]], dtype=torch.float32, device=src.device)
    shift = torch.tensor([0.05, -0.03, 0.0], device=src.device)
    mask = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    return src, mask, (src @ rot.T + shift).contiguous(), mask


def record_icp_rounds(source, source_mask, target, target_mask, threshold: float,
                      max_iterations: int, sweep: str = "compact"):
    """Run cached ICP as GMFA does, with a recorder around its active query.

    Returns ``(result, rounds, busiest)``: ``rounds`` holds each round's
    ``(points, active, index, cap2)``, the query's inputs, and with
    ``sweep="inplace"`` also its ``block_table`` and ``drift``; ``busiest`` is
    the round after the first with the most active rows (None if no later
    round swept a row)."""
    rounds = []
    if sweep == "compact":
        name = "nearest_neighbors_active"
        original = icp.nearest_neighbors_active

        def recorder(pts, tgt, tgt_mask, active, index=None, cap2=None):
            rounds.append((pts.clone(), active.clone(), index, cap2))
            return original(pts, tgt, tgt_mask, active, index=index, cap2=cap2)
    else:
        name = "nearest_neighbors_active_inplace"
        original = icp.nearest_neighbors_active_inplace

        def recorder(pts, tgt, tgt_mask, active, index, cap2=None, block_table=None,
                     drift=None):
            rounds.append((pts.clone(), active.clone(), index, cap2, block_table,
                           drift.clone()))
            return original(pts, tgt, tgt_mask, active, index, cap2=cap2,
                            block_table=block_table, drift=drift)

    with mock.patch.object(icp, name, recorder):
        res = icp.registration_icp(source, source_mask, target, target_mask, threshold,
                                   max_iterations, cached=True, sweep=sweep)
    counts = [int(r[1].sum()) for r in rounds]
    later = [i for i in range(1, len(rounds)) if counts[i] > 0]
    busiest = max(later, key=lambda i: counts[i]) if later else None
    return res, rounds, busiest


def round_inputs(rnd) -> nn_kernels.Prepared:
    """K5's inputs for a recorded round, as ``ops/nn.nearest_neighbors_active``
    (or, for an in-place round, ``nearest_neighbors_active_inplace``)
    prepares them."""
    pts, active, index, cap2 = rnd[:4]
    if len(rnd) == 4:
        src_c, _, n_active = nn.partition_active(pts.to(torch.float32), active)
        return nn_kernels.prepare(src_c, index, n_active, cap2)
    src_clean, counts = nn.inplace_inputs(pts, active)
    return nn_kernels.prepare(src_clean, index, cap2=cap2, block_counts=counts,
                              block_table=rnd[4], drift=rnd[5])


def icp_tile_probe(source, source_mask, target, target_mask, threshold: float,
                   max_iterations: int, card: str) -> dict:
    """Run cached ICP as GMFA does and read the tiles K5 visits in the first
    round and in the active round with the most rows."""
    res, rounds, busiest = record_icp_rounds(source, source_mask, target, target_mask,
                                             threshold, max_iterations)
    active_counts = [int(r[1].sum()) for r in rounds]
    out = {"iterations": int(res.iterations), "fitness": float(res.fitness),
           "active_rows_per_round": active_counts, "rounds": {}}
    for label, i in (("first", 0), ("active", busiest)):
        if i is None:
            continue
        pts = rounds[i][0]
        v = tile_visits(round_inputs(rounds[i]))
        v["round"] = i
        out["rounds"][label] = v
        print(f"K5 tiles per block, ICP {label} round ({i}): {v['active_rows']} active rows, "
              f"{v['live_blocks']} live blocks of {-(-pts.shape[0] // nn_kernels.SRC_BLOCK)}, "
              f"visits mean {v['visits_mean']:.2f} median {v['visits_median']:.1f} max "
              f"{v['visits_max']} of {v['tiles']} tiles (block {v['busiest_block']}; the last "
              f"live block, which mixes active and inactive rows, is {v['last_live_block']}), "
              f"{v['ops'] / 1e9:.3f} Gop, bound {v['bound_us']:.3f} us ({v['bound_by']}), "
              f"busiest block's serial bound {v['serial_bound_us']:.3f} us on one SM "
              f"[{card}]", flush=True)
    print(f"ICP probe: {out['iterations']} rounds ran, fitness {out['fitness']:.6f}, active "
          f"rows per round {active_counts} [{card}]", flush=True)
    return out


def _k5_calls(fn) -> list:
    """Run ``fn()`` and return the inputs of every K5 call it made:
    ``(prepared, active)`` pairs, as ``nn_kernels.nearest_neighbors`` takes
    them to the sweep."""
    calls = []
    original = nn_kernels.nearest_neighbors

    def recorder(src, index, n_active=None, cap2=None, block_counts=None, block_table=None,
                 drift=None):
        p = nn_kernels.prepare(src, index, n_active, cap2, block_counts, block_table, drift)
        calls.append((p, n_active is not None or block_counts is not None))
        return original(src, index, n_active, cap2, block_counts, block_table, drift)

    with mock.patch.object(nn_kernels, "nearest_neighbors", recorder):
        fn()
    return calls


def _device_us(fn, dev: torch.device, reps: int, launches: int = 1) -> float | None:
    """``measure.device_us_per_call``, or None (not measured, and said so)
    when the profiler loses its traces: these times are a breakdown, not a
    check."""
    try:
        return device_us_per_call(fn, dev, reps=reps, launches=launches)
    except LostTrace as e:
        print(f"device time not measured: {e}", flush=True)
        return None


def sweep_ab(source, source_mask, target, target_mask, threshold: float, max_iterations: int,
             card: str, reps: int = 3) -> dict:
    """One cached ICP with each sweep, ``"compact"`` and ``"inplace"`` (the
    port's counterpart of the JAX package's r4 A/B, ``ops/icp.py:298-300``):
    per sweep the ms of the whole ICP (median of ``reps``), K5's device ms
    over it (its sweeps recorded, then replayed under the profiler) and the
    sum of their bounds (:func:`sweeps_bound_us`), and for
    its busiest round (:func:`record_icp_rounds`) K5's device µs, the tiles
    visited and the busiest block's serial bound and device µs (the kernel
    launched with that block alone live); and each transform's largest
    difference from the other sweep's and from the uncached loop's.  Device
    times are None on the CPU."""
    dev = source.device
    args = (source, source_mask, target, target_mask, threshold, max_iterations)
    plain = icp.registration_icp(*args, cached=False)
    out = {"card": card}
    for sweep in ("compact", "inplace"):
        def run():
            return icp.registration_icp(*args, cached=True, sweep=sweep)

        res = run()
        row = {"ms": ms_per_call(run, dev, reps=reps, warmup=1),
               "iterations": int(res.iterations), "fitness": float(res.fitness),
               "sweep_stats": [int(x) for x in res.sweep_stats.tolist()],
               "transform": res.transformation,
               "vs_uncached": float((res.transformation - plain.transformation).abs().max())}
        calls = _k5_calls(run)
        row["k5_launches"] = len(calls)
        _, rounds, busiest = record_icp_rounds(*args, sweep=sweep)
        rnd = {"round": busiest, "k5_us": None, "busiest_block_us": None}
        if busiest is not None:
            p = round_inputs(rounds[busiest])
            rnd.update(tile_visits(p))
            rnd["serial_bound_us_kept"] = roofline.nearest_neighbors_serial_us(
                rnd["visits_max"], 16)
            if dev.type == "cuda":
                one = torch.zeros_like(p.block_counts)
                b = rnd["busiest_block"]
                one[b] = p.block_counts[b]
                alone = p._replace(block_counts=one)
                rnd["k5_us"] = _device_us(
                    lambda: nn_kernels._sweep_kernel(p, active=True), dev, reps=3)
                rnd["busiest_block_us"] = _device_us(
                    lambda: nn_kernels._sweep_kernel(alone, active=True), dev, reps=3)
        row["busiest_round"] = rnd
        us = _device_us(lambda: [nn_kernels._sweep_kernel(q, active=a) for q, a in calls], dev,
                        reps=1, launches=len(calls))
        row["k5_device_ms"] = None if us is None else us / 1e3
        row["k5_bound_us"] = sweeps_bound_us(calls)
        out[sweep] = row
        print(f"ICP sweep={sweep}: {row['ms']:.3f} ms per ICP, {row['iterations']} rounds, "
              f"fitness {row['fitness']:.6f}, stats {row['sweep_stats']}, K5 {len(calls)} "
              f"launches, device {fmt(row['k5_device_ms'])} ms (bound "
              f"{row['k5_bound_us']:.1f} us); busiest round {busiest}: "
              f"{rnd.get('active_rows')} active rows in {rnd.get('live_blocks')} live blocks, K5 "
              f"{fmt(rnd['k5_us'], '.1f')} us, busiest block {rnd.get('busiest_block')} visits "
              f"{rnd.get('visits_max')} of {rnd.get('tiles')} tiles, alone "
              f"{fmt(rnd['busiest_block_us'], '.1f')} us (serial bound "
              f"{rnd.get('serial_bound_us', 0.0):.1f} us on one SM); |T - T_uncached| "
              f"{row['vs_uncached']:.3e} [{card}]", flush=True)
    out["inplace_vs_compact"] = float(
        (out["inplace"]["transform"] - out["compact"]["transform"]).abs().max())
    print(f"ICP sweeps: |T_inplace - T_compact| {out['inplace_vs_compact']:.3e} [{card}]",
          flush=True)
    for sweep in ("compact", "inplace"):
        out[sweep]["transform"] = out[sweep]["transform"].cpu().tolist()
    return out


def parent_icp(parent: str | Path):
    """``ops/icp.py`` of the checkout at ``parent`` as a module of its own."""
    path = Path(parent) / "datmo_using_optical_flow_tpu_torch" / "ops" / "icp.py"
    spec = importlib.util.spec_from_file_location("parent_icp", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _turns_row(name: str, body_of, modules: dict, steps: int, dev: torch.device, card: str,
               reps: int) -> dict:
    """``body_of(module)`` for each of ``modules`` ({"package": icp, "parent":
    its parent}) in turns: the parent, the package twice, the parent; the
    best total of each."""
    runs = {"package": [], "parent": []}
    for key in ("parent", "package", "package", "parent"):
        runs[key].append(_loop_row(f"{name} [{key}]", body_of(modules[key]), steps, dev, card,
                                   reps))
    row = {"name": name, "steps": steps, "turns": runs}
    for key, prefix in (("package", ""), ("parent", "parent_")):
        best = min(runs[key], key=lambda r: r["ms_total"])
        row.update({f"{prefix}{k}": best[k] for k in ("ms_total", "ms_per_step",
                                                       "device_ms_total")})
    return row


def run(src, dst, weights, device: str | torch.device = "cuda", steps: int = 30,
        reps: int = 3, probe=None, threshold: float = 0.02, max_iterations: int = 30,
        parent: str | Path | None = None) -> dict:
    """Rows for the (N, 3) clouds ``src``, ``dst`` and (N,) ``weights``;
    ``probe`` = (source, source_mask, target, target_mask) for the tile probe
    (default: ``src`` against itself turned and moved a little); ``parent``
    as ``--parent``."""
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
    probe = tuple(torch.as_tensor(t, device=dev) for t in probe)
    if parent is not None:
        modules = {"package": icp, "parent": parent_icp(parent)}
        a = np.deg2rad(0.2)
        moved = torch.tensor([[np.cos(a), -np.sin(a), 0, 0.05], [np.sin(a), np.cos(a), 0, -0.03],
                              [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32, device=dev)

        def algebra(m):
            def body(i):
                cache = state.get(m, (fixed[1], d, s, fixed[3]))
                state[m] = m._eval_cached(s, mask, d, mask, thr2, moved, cache, live, None,
                                          None, lambda *a, **k: fixed)[4]
            return body

        rows += [
            _turns_row(f"transform_points ({n} points)",
                       lambda m: lambda i: m.transform_points(s, moved), modules, steps, dev,
                       card, reps),
            _turns_row("eval_cached algebra (no K5), moved", algebra, modules, steps, dev, card,
                       reps),
            _turns_row(f"registration_icp cached ({max_iterations} rounds)",
                       lambda m: lambda i: m.registration_icp(*probe, threshold, max_iterations,
                                                              cached=True),
                       modules, 1, dev, card, reps)]
    tiles = icp_tile_probe(*probe, threshold, max_iterations, card)
    return {"card": card, "device": str(dev), "points": n, "steps": steps, "rows": rows,
            "tile_probe": tiles, "parent": None if parent is None else str(parent)}


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
    ap.add_argument("--parent", help="an older checkout whose ops/icp.py to time beside")
    ap.add_argument("--sweeps", action="store_true",
                    help="only sweep_ab at GMFA's reference load (frames 0 -> 1)")
    args = ap.parse_args()
    if args.sweeps:
        from datmo_using_optical_flow_tpu_torch.diagnostics.icp_sound import reference_clouds

        pipe, cl = reference_clouds()
        icp_cfg = pipe.cfg.icp
        print(json.dumps(sweep_ab(*cl[0], *cl[1], icp_cfg.threshold, icp_cfg.max_iterations,
                                  card_label(pipe.device))))
        return
    print(json.dumps(run(*clouds(args.points), threshold=0.2, parent=args.parent)))


if __name__ == "__main__":
    main()
