#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a CUDA
device, ``nvcc`` and the checkout; without them it fails before printing any
result.  Phases (each raises on failure, so the script exits non-zero):

1. device and toolchain: the card, its power limit, torch/CUDA/nvcc versions;
2. build of the CUDA kernels from ``datmo_using_optical_flow_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the CPU tests' tolerances, and both timed (CUDA
   events, median of 20 calls each, in turns plain, kernel, kernel, plain);
4. the same at the CPU tests' other shapes and options (untimed);
5. the 256x320 slice on the card (kernels) against the CPU (plain versions);
6. pipeline A's main path: the stream step on 25 ``bench.make_frames``
   1080x1920 frames with ``bench.py``'s configuration, counting each kernel's
   launches, and frames/s over the 24 steps after the priming frame; the
   warm-up steps run with synchronising CUDA operations turned into errors;
7. K5 (the NN sweep) against its plain version at GMFA's reference load
   (102,400 x 102,400 points): uncapped, with the classification cap, and an
   ICP-style active subset; its bounds checked sound against a float64
   ``cKDTree`` on 4096 sampled rows; both timed as in phase 3;
8. the GMFA step at a small configuration on the card against the CPU;
9. GMFA's main path: ``benchmarks/bench_gmfa.py``'s scene and configuration
   (7 frames, 102,400 expanded points per cloud), ``seed_carry`` and 6
   ``step`` calls, with K5's launches and the host synchronisations per step.

The GMFA clouds are made with numpy and the port's point ops: flip x, drop
``|z| <= 0.5`` (a stand-in for RANSAC ground removal on the z = 0 plane, which
the port does not have yet), the ROI, compaction and densification x10.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "poly_exp": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:194",
    "blur_solve": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:78",
    "fused_iteration": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:435",
    "nearest_neighbors": "datmo_using_optical_flow_tpu/ops/nn_pallas.py:402",
}
SOURCES = {"poly_exp": "flow_kernels.cu", "blur_solve": "flow_kernels.cu",
           "fused_iteration": "flow_kernels.cu", "nearest_neighbors": "nn_kernels.cu"}
PER_STEP = {"poly_exp": 3, "fused_iteration": 10, "blur_solve": 5}  # 1080p, 3 levels
TOL = {"poly_exp": 1e-5, "blur_solve": 1e-4, "fused_iteration": 2e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_pair(plain, kernel, rounds: int = 10, warmup: int = 3) -> tuple[float, float]:
    """Median ms per call of (kernel, plain): CUDA events around each call,
    calls in turns plain, kernel, kernel, plain (2 * rounds calls each)."""
    fns = {"plain": plain, "kernel": kernel}
    times = {"plain": [], "kernel": []}
    for _ in range(warmup):
        plain()
        kernel()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name in ("plain", "kernel", "kernel", "plain"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x, y) for x, y in zip(a, b))
    return float(torch.max(torch.abs(a - b)))


def smooth_flow(h: int, w: int, dev, amp: float = 4.0):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    dx = amp * torch.sin(yy / 23) * torch.cos(xx / 31)
    dy = 0.7 * amp * torch.cos(yy / 19) * torch.sin(xx / 37)
    return dx.contiguous(), dy.contiguous()


def kernel_phases(dev, name: str, smi: str, h: int, w: int) -> dict:
    """Each kernel against its plain version at the main path's shapes, timed."""
    from bench import make_frames
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    frames = make_frames(2, h, w, seed=0)
    # levels coarsest first: 97x173, 324x576, 1080x1920 at 1080p (K1 runs here too)
    pyr = [fb.build_pyramid(torch.as_tensor(f, device=dev).float(), 0.3, 5, 5, 5.0)
           for f in frames]
    results = {k: {"max_abs_err": 0.0} for k in REPLACES}

    def record(kernel: str, label: str, err: float, scale: float, ms: float, plain_ms: float,
               timed: bool):
        log(f"{kernel} {label}: max_abs_err {err:.3e} (tol {TOL[kernel]:g}"
            f"{f' x plane scale {scale:.3e}' if scale != 1.0 else ''}) kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms [{name}, {smi}]")
        if err > TOL[kernel] * scale:
            raise AssertionError(f"{kernel} {label}: error {err} over tolerance")
        res = results[kernel]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if timed:
            res["ms"], res["plain_ms"] = ms, plain_ms

    top = len(pyr[0]) - 1
    for level in (top, top - 1):  # the full-size level and the next
        k = top - level
        lh, lw = pyr[0][level].shape[1:]
        sigma = (1.0 / 0.3 ** k - 1.0) * 0.5
        full = torch.as_tensor(frames[0], device=dev).float()
        img = fb.resize_bilinear(fb.gaussian_blur(full, max(int(round(sigma * 5)) | 1, 3), sigma),
                                 lh, lw).contiguous()
        got, want = fk.poly_exp(img, 5, 5.0), fk.poly_exp_reference(img, 5, 5.0)
        ms, plain_ms = time_pair(lambda: fk.poly_exp_reference(img, 5, 5.0),
                                 lambda: fk.poly_exp(img, 5, 5.0))
        record("poly_exp", f"{lh}x{lw}", max_abs(got, want), float(want.abs().max()), ms,
               plain_ms, timed=level == top)

    R0, R1 = pyr[0][0], pyr[1][0]  # the coarsest level
    zero = torch.zeros(R0.shape[1:], dtype=torch.float32, device=dev)
    M = fb.update_matrices(R0, R1, zero, zero, fb.pack_corner_pairs(R1))
    for gaussian in (False, True):
        got, want = fk.blur_solve(M, 15, gaussian), fk.blur_solve_reference(M, 15, gaussian)
        ms, plain_ms = time_pair(lambda: fk.blur_solve_reference(M, 15, gaussian),
                                 lambda: fk.blur_solve(M, 15, gaussian))
        record("blur_solve", f"{R0.shape[1]}x{R0.shape[2]} {'gauss' if gaussian else 'box'}",
               max_abs(got, want), 1.0, ms, plain_ms, timed=not gaussian)

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(pyr[0][top], pyr[1][top]), (pyr[0][top - 1], pyr[1][top - 1]),
             (torch.randn((5, 130, 384), device=dev, generator=gen),
              torch.randn((5, 130, 384), device=dev, generator=gen))]
    for i, (R0, R1) in enumerate(cases):  # h = 130: h % 32 < winsize // 2
        dx, dy = smooth_flow(R0.shape[1], R0.shape[2], dev)
        got = fk.fused_iteration(R0, R1, dx, dy, 15)
        want = fk.fused_iteration_reference(R0, R1, dx, dy, 15)
        ms, plain_ms = time_pair(lambda: fk.fused_iteration_reference(R0, R1, dx, dy, 15),
                                 lambda: fk.fused_iteration(R0, R1, dx, dy, 15))
        record("fused_iteration", f"{R0.shape[1]}x{R0.shape[2]}", max_abs(got, want), 1.0, ms,
               plain_ms, timed=i == 0)
    return results


def other_shapes_phase(dev) -> None:
    """The CPU tests' other shapes and options on the card, untimed: ragged
    tiles, poly_n = 7, Gaussian windows, and winsize 31, whose shared memory
    (85 KB) needs the dynamic opt-in above 48 KB."""
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    checks = []
    for h, w, n, sigma in ((37, 131, 5, 5.0), (64, 200, 7, 1.5)):
        img = rand(h, w) * 50 + 100
        want = fk.poly_exp_reference(img, n, sigma)
        checks.append(("poly_exp", f"{h}x{w} n={n}", max_abs(fk.poly_exp(img, n, sigma), want),
                       float(want.abs().max())))
    for h, w, win, gauss in ((17, 33, 7, True), (30, 41, 31, False), (64, 128, 15, True)):
        M = rand(5, h, w) ** 2
        checks.append(("blur_solve", f"{h}x{w} win={win} gauss={gauss}",
                       max_abs(fk.blur_solve(M, win, gauss),
                               fk.blur_solve_reference(M, win, gauss)), 1.0))
    for h, w, win, gauss in ((132, 384, 7, True), (160, 384, 31, False), (140, 300, 15, False)):
        R0, R1 = rand(5, h, w), rand(5, h, w)
        dx, dy = smooth_flow(h, w, dev)
        checks.append(("fused_iteration", f"{h}x{w} win={win} gauss={gauss}",
                       max_abs(fk.fused_iteration(R0, R1, dx, dy, win, gauss),
                               fk.fused_iteration_reference(R0, R1, dx, dy, win, gauss)), 1.0))
    for kernel, label, err, scale in checks:
        log(f"{kernel} {label}: max_abs_err {err:.3e} (tol {TOL[kernel]:g}"
            f"{f' x plane scale {scale:.3e}' if scale != 1.0 else ''})")
        if err > TOL[kernel] * scale:
            raise AssertionError(f"{kernel} {label}: error {err} over tolerance")


def bench_config(h: int, w: int, max_cells: int):
    from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig

    cfg = PipelineAConfig(x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1),
                          grid_resolution=(0.1, 0.1),
                          capacities=CapacityConfig(max_cells=max_cells, max_clusters=32,
                                                    max_tracks=64))
    assert cfg.grid_shape == (h, w), cfg.grid_shape
    return cfg


def slice_phase(dev, h: int, w: int) -> None:
    """The slice on the card (kernels) against the CPU (plain versions)."""
    from bench import make_frames
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

    cfg = bench_config(h, w, 1024)
    gpipe, cpipe = PipelineA(cfg, dev), PipelineA(cfg, "cpu")
    gc, cc = gpipe.init_stream_carry(), cpipe.init_stream_carry()
    for i, f in enumerate(make_frames(3, h, w)):
        gc, go = gpipe.step_stream(torch.as_tensor(f, device=dev), gc)
        cc, co = cpipe.step_stream(torch.as_tensor(f), cc)
        if i == 0:
            continue  # the priming frame's outputs are skipped
        verr = max(max_abs(go.velocity_x.cpu(), co.velocity_x),
                   max_abs(go.velocity_y.cpu(), co.velocity_y))
        same = float((go.labels.cpu() == co.labels).float().mean())
        log(f"slice {h}x{w} frame {i}: velocity max_abs_err {verr:.3e} (tol 1e-3), cells "
            f"{int(go.cell_count)}/{int(co.cell_count)} (card/CPU), label agreement "
            f"{same:.4f}, tracks {int(go.snapshot.alive.sum())}/{int(co.snapshot.alive.sum())}")
        if verr > 1e-3:
            raise AssertionError(f"slice frame {i}: velocity error {verr} over 1e-3")


def main_path(dev, name: str, smi: str, h: int, w: int, n_frames: int) -> dict:
    """bench.py's workload through the port: prime, then n_frames - 1 steps."""
    from bench import make_frames
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    cfg = bench_config(h, w, 4096)
    bevs = [torch.as_tensor(f, device=dev) for f in make_frames(n_frames, h, w)]
    pipe = PipelineA(cfg, dev, fast_warp=True)
    carry = pipe.init_stream_carry()  # warm-up, not counted
    torch.cuda.set_sync_debug_mode("error")  # a step that waits for the device raises
    for f in bevs[:2]:
        carry, _ = pipe.step_stream(f, carry)
    torch.cuda.set_sync_debug_mode("default")
    log("warm-up steps: no host synchronisation (torch.cuda.set_sync_debug_mode)")
    torch.cuda.synchronize()

    fk.reset_launches()
    carry = pipe.init_stream_carry()
    carry, out = pipe.step_stream(bevs[0], carry)  # prime the pyramid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in bevs[1:]:
        carry, out = pipe.step_stream(f, carry)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    n_levels = len(carry.pyr)
    log(f"{h}x{w} launches over {n_frames} steps ({n_levels} levels): {launches}")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (out.velocity_x, out.velocity_y, out.magnitude, carry.step.table.state))
    cells, alive = int(out.cell_count), int(carry.step.table.alive.sum())
    fps = (n_frames - 1) / elapsed
    log(f"{h}x{w} main path: {fps:.3f} frames/s ({elapsed / (n_frames - 1) * 1e3:.3f} ms/frame "
        f"over {n_frames - 1} steps), cells {cells}, alive tracks {alive} [{name}, {smi}]")
    if not finite or cells <= 0 or bool(out.skip):
        raise AssertionError(f"outputs: finite={finite} cells={cells} skip={bool(out.skip)}")
    return launches


# ------------------------------------------------------------------ GMFA (pipeline B)

def _synthetic_module():
    """``datmo_using_optical_flow_tpu/sim/synthetic.py`` loaded by file path:
    it needs only numpy, while the JAX package's ``__init__`` imports yaml."""
    path = os.path.join(ROOT, "datmo_using_optical_flow_tpu", "sim", "synthetic.py")
    spec = importlib.util.spec_from_file_location("_datmo_synthetic", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve their module by name
    spec.loader.exec_module(mod)
    return mod


def gmfa_clouds(scene, cfg, n_frames: int, dev, seed: int, dt: float | None = None):
    """Expanded clouds ((P, 3), (P,)) on ``dev`` for frames 0..n_frames-1,
    ``dt`` seconds apart (default: the configuration's)."""
    from datmo_using_optical_flow_tpu_torch.ops import points as point_ops
    from datmo_using_optical_flow_tpu_torch.utils.padding import compact_masked

    synth = _synthetic_module()
    rng = np.random.default_rng(seed)
    caps = cfg.capacities
    out = []
    for i in range(n_frames):
        raw = synth.synthetic_frame(scene, i, dt=cfg.dt if dt is None else dt)
        raw = torch.as_tensor(raw.astype(np.float32))
        p = point_ops.flip_x(raw)
        # stand-in for RANSAC ground removal (the ground is the z = 0 plane)
        keep = (p[:, 2].abs() > 0.5) & point_ops.roi_mask(p, cfg.roi_bounds)
        cpts, cmask, _ = compact_masked(p, keep, caps.max_roi_points)
        noise = rng.normal(0.0, cfg.noise_std, size=(caps.max_expanded_points, 3))
        ex, exm = point_ops.densify(cpts, cmask, torch.as_tensor(noise.astype(np.float32)),
                                    caps.expansion_factor)
        out.append((ex.to(dev).contiguous(), exm.to(dev)))
    return out


def bench_gmfa_setup():
    """``benchmarks/bench_gmfa.py``'s configuration and scene (seed 42)."""
    from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, GMFAConfig

    synth = _synthetic_module()
    box = synth.BoxTarget
    cfg = GMFAConfig(capacities=CapacityConfig(max_raw_points=65536, max_roi_points=10240,
                                               max_cells=4096, max_clusters=32, max_tracks=64))
    scene = synth.SyntheticScene(
        ground_points=40000, ground_extent=25.0,
        static_boxes=(box(center0=(-8.0, 6.0, 1.0), velocity=(0, 0), points_per_frame=4000),),
        targets=(box(center0=(6.0, -4.0, 0.75), velocity=(1.5, 0.8), points_per_frame=4000),
                 box(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
                     points_per_frame=4000),
                 box(center0=(0.0, 10.0, 0.75), velocity=(0.5, -1.5), points_per_frame=4000)),
        seed=42)
    return cfg, scene


def _nn_compare(label: str, got, want, rows) -> float:
    """Max abs error over the float outputs at ``rows``; raises unless every
    idx matches (or is a near-tie) and the floats agree within 1e-5 relative."""
    gi, gd, gl, gb, gc = (t[rows] for t in got)
    wi, wd, wl, wb, wc = (t[rows] for t in want)
    mism = gi != wi
    n_mism = int(mism.sum())
    err = 0.0
    for g, w in ((gd, wd), (gl, wl), (gb, wb), (gc, wc)):
        fin = torch.isfinite(w)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f"K5 {label}: finite entries differ")
        if bool(fin.any()):
            diff = (g[fin] - w[fin]).abs()
            if not bool((diff <= 1e-5 * (1.0 + w[fin].abs())).all()):
                raise AssertionError(f"K5 {label}: max error {float(diff.max())} over tolerance")
            err = max(err, float(diff.max()))
    if n_mism and not bool(((gd[mism] - wd[mism]).abs() <= 1e-5 * (1.0 + wd[mism])).all()):
        raise AssertionError(f"K5 {label}: {n_mism} idx mismatches beyond near-ties")
    log(f"K5 {label}: idx mismatches {n_mism} of {int(rows.sum())}, max_abs_err {err:.3e} "
        f"(tol 1e-5 relative)")
    return err


def _nn_sound(label: str, src, tgt, tgt_mask, lo, d2nd, rows, seed: int) -> None:
    """lo and d2nd <= the float64 truth (cKDTree) on 4096 sampled rows."""
    from scipy.spatial import cKDTree

    tgt_np = tgt.cpu().numpy().astype(np.float64)[tgt_mask.cpu().numpy()]
    cand = np.nonzero(rows.cpu().numpy())[0]
    pick = np.random.default_rng(seed).choice(cand, size=min(4096, len(cand)), replace=False)
    dist, _ = cKDTree(tgt_np).query(src.cpu().numpy()[pick].astype(np.float64), k=2)
    d1, d2 = dist[:, 0] ** 2, dist[:, 1] ** 2
    lo_s = lo.cpu().numpy()[pick].astype(np.float64)
    b2_s = d2nd.cpu().numpy()[pick].astype(np.float64)
    bad_lo = int(np.sum(lo_s > d1 + 1e-5 * (1.0 + d1)))
    bad_b2 = int(np.sum(b2_s > d2 + 1e-5 * (1.0 + d2)))
    log(f"K5 {label} soundness vs float64 cKDTree on {len(pick)} rows: lo violations {bad_lo}, "
        f"d2nd violations {bad_b2}, max lo/d1 slack {float(np.max(lo_s - d1)):.3e}")
    if bad_lo or bad_b2:
        raise AssertionError(f"K5 {label}: unsound bounds ({bad_lo}, {bad_b2})")


def _device_us(fn, needle: str) -> str:
    """Mean device time per launch of the kernels whose name holds ``needle``
    over 5 profiled calls, or "not measured" when the trace has none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if needle in ev.key and ev.count:
            total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if total:
                return f"{total / ev.count:.1f}"
    return "not measured"


def nn_phase(dev, name: str, smi: str, clouds) -> dict:
    """K5 against its plain version at reference load, timed."""
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5

    (prev, prev_m), (cur, cur_m) = clouds[0], clouds[1]
    index = k5.build_target_index(cur, cur_m)
    # the classification sweep's and eval_full's layout: sources Morton-sorted
    order = k5.sort_order(prev, prev_m).long()
    src, src_valid = prev[order].contiguous(), prev_m[order]
    cls_cap2 = float(np.float32(1.2) * np.float32(1.2))
    icp_cap2 = float(np.float32(0.1) * np.float32(0.1))
    # an ICP-style active subset (~13%), stably partitioned to the front
    gen = torch.Generator(device=dev).manual_seed(3)
    active = src_valid & (torch.rand(src.shape[0], generator=gen, device=dev) < 0.13)
    part = torch.cat([torch.nonzero(active)[:, 0], torch.nonzero(~active)[:, 0]])
    src_c = src[part].contiguous()
    n_act = int(active.sum())
    table = k5.build_block_table(src_c, index)
    cases = [("uncapped", src, {}, src_valid),
             ("capped (2*0.6)^2", src, {"cap2": cls_cap2}, src_valid),
             (f"active {n_act}/{src.shape[0]} cap (5*0.02)^2", src_c,
              {"n_active": n_act, "cap2": icp_cap2, "block_table": table},
              torch.arange(src.shape[0], device=dev) < n_act)]
    res = {"max_abs_err": 0.0}
    for i, (label, s, kw, rows) in enumerate(cases):
        got = k5.nearest_neighbors(s, index, **kw)
        want = k5.nearest_neighbors_reference(s, index, **kw)
        torch.cuda.synchronize()
        res["max_abs_err"] = max(res["max_abs_err"], _nn_compare(label, got, want, rows))
        _nn_sound(label, s, cur, cur_m, got[2], got[3], rows, seed=i)
        ms, plain_ms = time_pair(lambda: k5.nearest_neighbors_reference(s, index, **kw),
                                 lambda: k5.nearest_neighbors(s, index, **kw),
                                 rounds=3, warmup=1)
        us = _device_us(lambda: k5.nearest_neighbors(s, index, **kw), "nn_sweep")
        log(f"K5 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (incl. the "
            f"block table), kernel device {us} us [{name}, {smi}]")
        if i == 0:
            res["ms"], res["plain_ms"] = ms, plain_ms
    return res


def gmfa_slice_phase(dev) -> None:
    """A small GMFA configuration on the card (kernels) against the CPU (plain
    versions), with the same clouds and new-track ids."""
    from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig,
                                                           GMFAConfig, IcpConfig)
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline

    synth = _synthetic_module()
    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30), icp=IcpConfig(threshold=0.2),
                     capacities=CapacityConfig(max_raw_points=8192, max_roi_points=512,
                                               max_cells=1024, max_clusters=8, max_tracks=16))
    scene = synth.SyntheticScene(seed=33, targets=(
        synth.BoxTarget(center0=(5.0, -4.0, 0.75), velocity=(1.5, 0.8), points_per_frame=300),
        synth.BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
                        points_per_frame=250)))
    clouds = gmfa_clouds(scene, cfg, 4, "cpu", seed=1, dt=1.0)  # as tests/test_gmfa_pipeline
    gpipe, cpipe = GMFAPipeline(cfg, 2048, dev), GMFAPipeline(cfg, 2048, "cpu")
    gc = gpipe.seed_carry(clouds[0][0].to(dev), clouds[0][1].to(dev))
    cc = cpipe.seed_carry(*clouds[0])
    rng = np.random.default_rng(7)
    for i in range(1, len(clouds)):
        ids = torch.as_tensor(rng.integers(0, 100000, 8).astype(np.int32))
        gc, go = gpipe.step(clouds[i][0].to(dev), clouds[i][1].to(dev), gc, ids.to(dev))
        cc, co = cpipe.step(*clouds[i], cc, ids)
        terr = max_abs(go.transformation.cpu(), co.transformation)
        agree = float((go.classifications.cpu() == co.classifications).float().mean())
        same = (int(go.moving_count) == int(co.moving_count)
                and torch.equal(go.labels.cpu(), co.labels)
                and torch.equal(gc.table.alive.cpu(), cc.table.alive)
                and torch.equal(gc.table.tid.cpu(), cc.table.tid))
        serr = max_abs(gc.table.state.cpu(), cc.table.state)
        log(f"GMFA slice frame {i}: transform max_abs_err {terr:.3e} (tol 1e-5), "
            f"classification agreement {agree:.5f} (>= 0.999), moving {int(go.moving_count)}/"
            f"{int(co.moving_count)}, clusters {int(go.n_clusters)}, tracks "
            f"{int(gc.table.alive.sum())}/{int(cc.table.alive.sum())}, state err {serr:.3e}")
        if terr > 1e-5 or agree < 0.999 or not same or serr > 1e-4:
            raise AssertionError(f"GMFA slice frame {i} disagrees with the CPU run")


def gmfa_main_path(dev, name: str, smi: str, n_frames: int) -> dict:
    """bench_gmfa.py's workload through the port: seed_carry, then n_frames - 1
    steps, at 102,400 expanded points per cloud."""
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow_tpu_torch.ops import icp as icp_ops
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5

    cfg, scene = bench_gmfa_setup()
    t0 = time.perf_counter()
    clouds = gmfa_clouds(scene, cfg, n_frames, dev, seed=0)
    n_exp = int(clouds[0][1].sum())
    log(f"GMFA clouds: {n_frames} x {clouds[0][0].shape[0]} expanded points ({n_exp} valid), "
        f"made in {time.perf_counter() - t0:.2f} s")
    pipe = GMFAPipeline(cfg, max_moving_points=16384, device=dev, seed=0)

    # warm-up (not counted): the first steps, with every host synchronisation
    # recorded through torch.cuda.set_sync_debug_mode
    carry = pipe.seed_carry(*clouds[0])
    syncs = []
    for i in (1, 2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                carry, out = pipe.step(*clouds[i], carry)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    log(f"GMFA warm-up steps: host synchronisations per step {syncs} "
        f"(torch.cuda.set_sync_debug_mode)")

    k5.reset_launches()
    carry = pipe.seed_carry(*clouds[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for i in range(1, n_frames):
        carry, out = pipe.step(*clouds[i], carry)
        outs.append(out)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = k5.LAUNCHES["nearest_neighbors"]
    steps = n_frames - 1
    for i, o in enumerate(outs, start=1):
        log(f"GMFA frame {i}: skip {bool(o.skip)}, moving {int(o.moving_count)}, clusters "
            f"{int(o.n_clusters)}, fitness {float(o.fitness):.6f}, |T - I| "
            f"{float((o.transformation - torch.eye(4, device=dev)).abs().max()):.3e}")
    alive = int(carry.table.alive.sum())
    icp = icp_ops.registration_icp(clouds[0][0], clouds[0][1], clouds[1][0], clouds[1][1],
                                   cfg.icp.threshold, cfg.icp.max_iterations,
                                   cfg.icp.relative_fitness, cfg.icp.relative_rmse)
    log(f"GMFA ICP frame 0 -> 1 (direct call): iterations {int(icp.iterations)}, fitness "
        f"{float(icp.fitness):.6f}, rmse {float(icp.inlier_rmse):.6f}, sweep stats "
        f"{[int(x) for x in icp.sweep_stats.tolist()]}")
    log(f"GMFA main path: {steps / elapsed:.3f} frames/s ({elapsed / steps * 1e3:.3f} ms/frame "
        f"over {steps} steps), K5 launches {launches} ({launches / steps:.1f} per step), "
        f"live tracks {alive} [{name}, {smi}]")
    finite = all(bool(torch.isfinite(t).all()) for o in outs
                 for t in (o.transformation, o.fitness, o.residuals))
    finite = finite and bool(torch.isfinite(carry.table.state).all())
    if not finite or launches <= 0 or sum(int(o.moving_count) for o in outs) <= 0:
        raise AssertionError(f"GMFA outputs: finite={finite} launches={launches}")
    return {"nearest_neighbors": launches}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    sys.path.insert(0, ROOT)
    from datmo_using_optical_flow_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"device: {name} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}, "
        f"python {sys.version.split()[0]}")

    path, seconds, text = build.build()
    build.library()
    log(f"build: {path.name} in {seconds:.2f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    results = kernel_phases(dev, name, smi, 1080, 1920)
    other_shapes_phase(dev)
    slice_phase(dev, 256, 320)
    n_frames = 25
    launches = main_path(dev, name, smi, 1080, 1920, n_frames)
    want = {k: v * n_frames for k, v in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    cfg, scene = bench_gmfa_setup()
    results["nearest_neighbors"] = nn_phase(dev, name, smi, gmfa_clouds(scene, cfg, 2, dev, 0))
    gmfa_slice_phase(dev)
    launches.update(gmfa_main_path(dev, name, smi, 7))

    kernels = [{"name": k, "route": "cuda",
                "source": f"datmo_using_optical_flow_tpu_torch/csrc/{SOURCES[k]}",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
                "plain_ms": results[k]["plain_ms"]} for k in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
