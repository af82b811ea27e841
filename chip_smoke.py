#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a CUDA
device, ``nvcc`` and the checkout; without them it fails before printing any
result.  It imports nothing of the JAX package or its scripts: frames and
scenes come from the port's own copies (``datmo_using_optical_flow_tpu_torch/
sim/``).  Phases (each raises on failure, so the script exits non-zero):

1. device and toolchain: the card, its power limit, torch/CUDA/nvcc versions;
2. build of the CUDA kernels from ``datmo_using_optical_flow_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, K1, K2 and K3 bit for bit (``torch.equal``), the others
   with the CPU tests' tolerances, and both timed (CUDA events, median of 20
   calls each, in turns plain, kernel, kernel, plain); K1 at all three
   pyramid levels and K3 at both levels that run it also by their device
   µs; K4 with the converged flow of two 1080x1920 frames, and K4 into K2
   bit-equal to K3 there; K1 (at each level) and K6 also beside one PyTorch
   call of the same function (``F.conv2d``, ``torch.add``), timed and not
   used by the port; K6's launch path split into its parts, each timed over
   1,000 calls;
4. the same at the CPU tests' other shapes and options (untimed): K1 at
   ragged shapes with poly_n 5 and 7, through both of its tile heights and
   both of its C paths (a sigma of 0.3 takes the runtime-n kernel), K4 at
   160x384, 130x384 and 160x1920 and K4 into K2 bit-equal to K3 at the
   shapes of ``tests/test_flow_pallas.py``;
5. the 256x320 slice on the card (kernels) against the CPU (plain versions);
6. pipeline A's main path: the stream step on 25 ``make_frames`` 1080x1920
   frames (``bench.py``'s workload) with ``bench.py``'s configuration,
   counting each kernel's launches, and frames/s over the 24 steps after the
   priming frame; the warm-up steps run with synchronising CUDA operations
   turned into errors;
7. GMFA's ``preprocess`` at the reference load
   (``benchmarks/gmfa_reference_load.py``'s configuration, scene and keys: 7
   frames of ~56,000 raw points, RANSAC with 5000 hypotheses, 102,400
   expanded points): its first call with synchronising CUDA operations
   turned into errors, then the card's clouds equal to the CPU port's bit
   for bit on frames 0-2, with float32 and with q16 points;
8. K5 (the NN sweep) bit-equal to its serial plain version on frames 0 and
   1 of those clouds: uncapped, with the classification cap, an ICP-style
   active subset, every target twice (tied minima), and the inputs of ICP's
   busiest active round on that frame pair; at each cluster size (1, 2, 4,
   8, 16 CTAs per block) with its device µs and the busiest block's serial
   bound, and at the kept sizes; its bounds checked sound against a float64
   ``cKDTree`` on 4096 sampled rows; wrapper and plain version timed as in
   phase 3;
9. the GMFA step at a small configuration on the card against the CPU, on
   clouds the port preprocessed, with the same step keys (so the same new
   track ids);
10. GMFA's main path on the 7 clouds: ``seed_carry`` and 6 ``step`` calls,
    with K5's launches, the host synchronisations per step and the moving
    points against the 16,384 cap; then K5's device ms per step, full and
    active sweeps apart, at the kept sizes and at each cluster size (one
    step's sweeps recorded, then replayed under the profiler);
11. the diagnostics that run K4 and K6, at full size, each with every launch
    count set to 0 just before it and read just after: ``micro_flow`` and
    ``profile_1080p`` on two ``make_frames`` 1080x1920 frames (K1-K4), and
    ``icp_body`` at 102,400 points (K6), whose K5 tile probe runs ICP on the
    preprocessed frame pair 0 -> 1 (K5);
12. pipeline A from PCD files at the reference's production shape
    (``benchmarks/from_points.py``: 12 frames of ~56,000 points, 5000 RANSAC
    hypotheses, a 200x200 BEV): the preprocess and step warm-up with
    synchronising CUDA operations turned into errors, the card's BEV equal
    to the CPU's on 3 frames, K1 and K2 bit-equal at 200x200 and 60x60 and
    timed, then ``process_files`` with float32 and with q16 points, each
    with the launch counts set to 0 just before and read just after (2 K1
    and 10 K2 launches per frame, no frame skipped, tracks out), and a
    4-frame run on the card against the CPU's;
13. GMFA from PCD files at a small configuration: ``process_files`` over 4
    ``synth`` frames on the card against the CPU (rows, track ids, states,
    SOM) and resumed on the card from a mid-run checkpoint (same rows);
14. the port's three benchmarks once each, shortened, each in its own
    process (``benchmarks/stream_1080p.py``, ``benchmarks/from_points.py``,
    ``benchmarks/gmfa_reference_load.py``).

The second-to-last line is a JSON summary of the kernels, each with its
bound on the H100 for the timed call's work (``diagnostics/roofline.py``);
the line before it is ``nvidia-smi``'s name and power limit of the card; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "poly_exp": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:194",
    "blur_solve": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:78",
    "fused_iteration": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:435",
    "warp_matrices": "datmo_using_optical_flow_tpu/ops/warp_pallas.py:308",
    "nearest_neighbors": "datmo_using_optical_flow_tpu/ops/nn_pallas.py:402",
    "tiny": "benchmarks/diag_icp_body.py:174",
}
SOURCES = {"poly_exp": "flow_kernels.cu", "blur_solve": "flow_kernels.cu",
           "fused_iteration": "flow_kernels.cu", "warp_matrices": "flow_kernels.cu",
           "nearest_neighbors": "nn_kernels.cu", "tiny": "probe_kernels.cu"}
PER_STEP = {"poly_exp": 3, "fused_iteration": 10, "blur_solve": 5}  # 1080p, 3 levels
TOL = {"warp_matrices": 2e-4}
EXACT = ("poly_exp", "blur_solve", "fused_iteration")  # held to torch.equal


def log(msg: str) -> None:
    print(msg, flush=True)


def _counted_modules():
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels, nn_kernels, probe_kernels

    return flow_kernels, nn_kernels, probe_kernels


def reset_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


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


def equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def check(kernel: str, label: str, got, want) -> float:
    """Raise unless ``got`` agrees with ``want``: bit for bit for K1, K2 and
    K3 (``EXACT``), else within ``TOL``.  Logs and returns the max
    abs error."""
    err = max_abs(got, want)
    if kernel in EXACT:
        ok, tol = equal(got, want), "bit-equal required"
    else:
        ok = err <= TOL[kernel]
        tol = f"tol {TOL[kernel]:g}"
    log(f"{kernel} {label}: max_abs_err {err:.3e} ({tol})")
    if not ok:
        raise AssertionError(f"{kernel} {label}: error {err} ({tol})")
    return err


def smooth_flow(h: int, w: int, dev, amp: float = 4.0):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    dx = amp * torch.sin(yy / 23) * torch.cos(xx / 31)
    dy = 0.7 * amp * torch.cos(yy / 19) * torch.sin(xx / 37)
    return dx.contiguous(), dy.contiguous()


def kernel_phases(dev, name: str, smi: str, h: int, w: int) -> dict:
    """Each kernel against its plain version at the main path's shapes, timed."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.diagnostics.measure import device_us_per_call
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    frames = make_frames(2, h, w, seed=0)
    # levels coarsest first: 97x173, 324x576, 1080x1920 at 1080p (K1 runs here too)
    pyr = [fb.build_pyramid(torch.as_tensor(f, device=dev).float(), 0.3, 5, 5, 5.0)
           for f in frames]
    results = {k: {"max_abs_err": 0.0} for k in REPLACES}
    top = len(pyr[0]) - 1

    def record(kernel: str, label: str, got, want, ms: float, plain_ms: float,
               timed: bool) -> None:
        err = check(kernel, label, got, want)
        log(f"{kernel} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{name}, {smi}]")
        res = results[kernel]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if timed:
            res["ms"], res["plain_ms"] = ms, plain_ms

    full = torch.as_tensor(frames[0], device=dev).float()
    k1_levels = results["poly_exp"]["levels"] = {}
    for level in range(top, -1, -1):  # every level K1 runs at, the full-size one first
        lh, lw = pyr[0][level].shape[1:]
        img = fb.level_image(full, 0.3 ** (top - level), lh, lw).contiguous()
        label = f"{lh}x{lw}"
        got, want = fk.poly_exp(img, 5, 5.0), fk.poly_exp_reference(img, 5, 5.0)
        ms, plain_ms = time_pair(lambda: fk.poly_exp_reference(img, 5, 5.0),
                                 lambda: fk.poly_exp(img, 5, 5.0))
        record("poly_exp", label, got, want, ms, plain_ms, timed=level == top)
        us = device_us_per_call(lambda: fk.poly_exp(img, 5, 5.0), dev)
        lib_ms = library_phase("poly_exp", label, poly_exp_conv(img, 5, 5.0), want,
                               1e-3 * float(want.abs().max()), dev, name, smi)
        bound = roofline.poly_exp(lh, lw).bound_us()
        k1_levels[label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us,
                            "library_ms": lib_ms, "bound_us": bound}
        log(f"poly_exp {label}: device {us:.1f} us per call, bound {bound:.3f} us, share "
            f"{bound / us:.3f} [{name}, {smi}]")
        if level == top:
            results["poly_exp"]["library_ms"] = lib_ms

    R0, R1 = pyr[0][0], pyr[1][0]  # the coarsest level
    zero = torch.zeros(R0.shape[1:], dtype=torch.float32, device=dev)
    M = fb.update_matrices(R0, R1, zero, zero, fb.pack_corner_pairs(R1))
    for gaussian in (False, True):
        got, want = fk.blur_solve(M, 15, gaussian), fk.blur_solve_reference(M, 15, gaussian)
        ms, plain_ms = time_pair(lambda: fk.blur_solve_reference(M, 15, gaussian),
                                 lambda: fk.blur_solve(M, 15, gaussian))
        record("blur_solve", f"{R0.shape[1]}x{R0.shape[2]} {'gauss' if gaussian else 'box'}",
               got, want, ms, plain_ms, timed=not gaussian)

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(pyr[0][top], pyr[1][top]), (pyr[0][top - 1], pyr[1][top - 1]),
             (torch.randn((5, 130, 384), device=dev, generator=gen),
              torch.randn((5, 130, 384), device=dev, generator=gen))]
    levels = results["fused_iteration"]["levels"] = {}
    for i, (R0, R1) in enumerate(cases):  # h = 130: h % 32 < winsize // 2
        dx, dy = smooth_flow(R0.shape[1], R0.shape[2], dev)
        got = fk.fused_iteration(R0, R1, dx, dy, 15)
        want = fk.fused_iteration_reference(R0, R1, dx, dy, 15)
        ms, plain_ms = time_pair(lambda: fk.fused_iteration_reference(R0, R1, dx, dy, 15),
                                 lambda: fk.fused_iteration(R0, R1, dx, dy, 15))
        label = f"{R0.shape[1]}x{R0.shape[2]}"
        record("fused_iteration", label, got, want, ms, plain_ms, timed=i == 0)
        if i < 2:  # the two levels that run K3 on the main path
            us = device_us_per_call(lambda: fk.fused_iteration(R0, R1, dx, dy, 15), dev)
            levels[label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us}
            log(f"fused_iteration {label}: device {us:.1f} us per call [{name}, {smi}]")

    # K4 with the two frames' converged flow, as the diagnostics run it
    flow = fb.flow_from_pyramids(pyr[0], pyr[1], 0.3, 15, 5, True, False)
    fdx, fdy = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    R0, R1 = pyr[0][top], pyr[1][top]
    got = fk.warp_matrices(R0, R1, fdx, fdy)
    want = fk.warp_matrices_reference(R0, R1, fdx, fdy)
    ms, plain_ms = time_pair(lambda: fk.warp_matrices_reference(R0, R1, fdx, fdy),
                             lambda: fk.warp_matrices(R0, R1, fdx, fdy))
    record("warp_matrices", f"{h}x{w} converged flow dx [{float(fdx.min()):.2f}, "
           f"{float(fdx.max()):.2f}] dy [{float(fdy.min()):.2f}, {float(fdy.max()):.2f}]",
           got, want, ms, plain_ms, timed=True)
    check_k4_into_k2(R0, R1, fdx, fdy, 15, False, f"{h}x{w} converged flow")
    return results


def check_k4_into_k2(R0, R1, dx, dy, win: int, gaussian: bool, label: str) -> None:
    """K4 then K2 equals K3, bit for bit (tests/test_flow_pallas.py:119-141
    on the card)."""
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    got = fk.blur_solve(fk.warp_matrices(R0, R1, dx, dy), win, gaussian)
    want = fk.fused_iteration(R0, R1, dx, dy, win, gaussian)
    err = max_abs(got, want)
    log(f"warp_matrices into blur_solve vs fused_iteration {label} win={win} gauss={gaussian}: "
        f"max_abs_err {err:.3e} (bit-equal required)")
    if not equal(got, want):
        raise AssertionError(f"K4 into K2 {label}: differs from K3 (max_abs_err {err})")


def poly_exp_conv(img, n: int, sigma: float):
    """One ``F.conv2d`` that computes K1's function: a (5, 1, 2n+1, 2n+1)
    weight of the outer products of g, xg and xxg scaled by the inverse-Gram
    entries, on the replicate-padded image, with TF32 off.  Timed beside K1;
    the port does not use it."""
    import torch.nn.functional as F

    from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import prepare_gaussian
    from datmo_using_optical_flow_tpu_torch.utils import device as _device  # noqa: F401

    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN TF32 is on")
    g, xg, xxg, ig = (np.asarray(a, np.float64) for a in prepare_gaussian(n, sigma))
    w = np.stack([np.outer(xg, g) * ig[1, 1], np.outer(g, xg) * ig[1, 1],
                  np.outer(g, g) * ig[0, 3] + np.outer(xxg, g) * ig[3, 3],
                  np.outer(g, g) * ig[0, 3] + np.outer(g, xxg) * ig[3, 3],
                  np.outer(xg, xg) * ig[5, 5]])
    weight = torch.as_tensor(w[:, None].astype(np.float32), device=img.device)
    padded = F.pad(img[None, None], (n, n, n, n), mode="replicate")
    return lambda: F.conv2d(padded, weight)[0]


def library_phase(kernel: str, label: str, lib, want, tol: float, dev, name: str,
                  smi: str) -> float:
    """ms of one PyTorch call computing the kernel's function, checked to
    compute it (within ``tol`` of the plain version)."""
    from datmo_using_optical_flow_tpu_torch.diagnostics.measure import ms_per_call

    err = max_abs(lib(), want)
    lib_ms = ms_per_call(lib, dev, reps=20, warmup=3)
    log(f"{kernel} {label} library call: {lib_ms:.4f} ms, max_abs_err vs plain {err:.3e} "
        f"(tol {tol:.3e}) [{name}, {smi}]")
    if err > tol:
        raise AssertionError(f"{kernel} library call: error {err} over {tol}")
    return lib_ms


def probe_phase(dev, name: str, smi: str) -> dict:
    """K6 against its plain version (bit-equal) at the ICP probe's (8, 128)."""
    from datmo_using_optical_flow_tpu_torch.ops import probe_kernels as pk

    x = torch.randn((8, 128), device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    got, want = pk.tiny(x), pk.tiny_reference(x)
    if not torch.equal(got, want):
        raise AssertionError("tiny: the kernel differs from x + 1.0")
    ms, plain_ms = time_pair(lambda: pk.tiny_reference(x), lambda: pk.tiny(x))
    log(f"tiny 8x128: bit-equal to its plain version, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms [{name}, {smi}]")
    lib_ms = library_phase("tiny", "8x128", lambda: torch.add(x, 1.0), want, 0.0, dev, name, smi)
    launch_path_breakdown(x, name, smi)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms}


def launch_path_breakdown(x, name: str, smi: str, n: int = 1000) -> dict:
    """Host µs per call of each part of K6's launch path (``kernels/build.Entry``),
    each over ``n`` calls in a Python loop on the host clock, beside the whole
    wrapper call and ``torch.add``: the wrapper's checks of its input, the
    output's allocation, the raw stream lookup, the ctypes call that launches
    the kernel (with its device guard in C), and the check of its return."""
    from datmo_using_optical_flow_tpu_torch.kernels import build
    from datmo_using_optical_flow_tpu_torch.ops import probe_kernels as pk
    from datmo_using_optical_flow_tpu_torch.ops.flow_kernels import _on_cuda

    fn, stream = pk._TINY.resolve()
    index = x.device.index
    out = torch.empty_like(x)
    args = (out.data_ptr(), x.data_ptr(), x.numel(), index, stream(index))

    def checks():
        return (x.dtype != torch.float32, x.is_contiguous(), x.numel(), _on_cuda(x),
                x.device.index, x.data_ptr(), out.data_ptr())

    parts = {"input checks and pointers": checks,
             "allocation (torch.empty_like)": lambda: torch.empty_like(x),
             "raw stream lookup": lambda: stream(index),
             "ctypes call (device guard, launch)": lambda: fn(*args),
             "check of the return": lambda: build.check(0, "tiny"),
             "whole tiny() call": lambda: pk.tiny(x),
             "torch.add(x, 1.0)": lambda: torch.add(x, 1.0)}
    us = {}
    for label, body in parts.items():
        body()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        us[label] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    log("tiny launch path, host us per call over " + str(n) + " calls: "
        + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + f" [{name}, {smi}]")
    return us


def other_shapes_phase(dev) -> None:
    """The CPU tests' other shapes and options on the card, untimed: ragged
    tiles, poly_n = 7, Gaussian windows, and winsize 31, whose shared memory
    (85 KB) needs the dynamic opt-in above 48 KB.  K1 takes both of its tile
    heights (16 rows where the 32-row grid has fewer blocks than the card has
    SMs), stores with and without float4 (w % 4), and both C paths: a sigma
    of 0.3 underflows g's end taps in float32, so it runs the runtime-n
    kernel."""
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    paths = set()
    for h, w, n, sigma in ((37, 131, 5, 5.0), (64, 200, 5, 5.0), (130, 1100, 5, 5.0),
                           (2, 3, 5, 5.0), (64, 200, 7, 1.5), (37, 131, 7, 1.5),
                           (330, 1003, 7, 1.5), (64, 200, 5, 0.3), (37, 131, 5, 0.3)):
        img = rand(h, w) * 50 + 100
        path = "compile-time instance" if fk.poly_exp_compiled(n, sigma) else "runtime-n kernel"
        paths.add(path)
        check("poly_exp", f"{h}x{w} n={n} sigma={sigma} ({path})", fk.poly_exp(img, n, sigma),
              fk.poly_exp_reference(img, n, sigma))
    if len(paths) != 2:
        raise AssertionError(f"K1's checks took only {paths}")
    for h, w, win, gauss in ((17, 33, 7, True), (30, 41, 31, False), (64, 128, 15, True)):
        M = rand(5, h, w) ** 2
        check("blur_solve", f"{h}x{w} win={win} gauss={gauss}", fk.blur_solve(M, win, gauss),
              fk.blur_solve_reference(M, win, gauss))
    for h, w, win, gauss in ((132, 384, 7, True), (160, 384, 31, False), (140, 300, 15, False)):
        R0, R1 = rand(5, h, w), rand(5, h, w)
        dx, dy = smooth_flow(h, w, dev)
        check("fused_iteration", f"{h}x{w} win={win} gauss={gauss}",
              fk.fused_iteration(R0, R1, dx, dy, win, gauss),
              fk.fused_iteration_reference(R0, R1, dx, dy, win, gauss))
    for h, w in ((160, 384), (130, 384), (160, 1920)):  # tests/test_torch_warp_matrices.py
        R0, R1 = rand(5, h, w), rand(5, h, w)
        dx, dy = smooth_flow(h, w, dev)
        check("warp_matrices", f"{h}x{w}", fk.warp_matrices(R0, R1, dx, dy),
              fk.warp_matrices_reference(R0, R1, dx, dy))
    for h, w, win, gauss in ((160, 384, 15, False), (140, 300, 15, False), (132, 384, 7, True),
                             (130, 384, 15, False)):
        dx, dy = smooth_flow(h, w, dev)
        check_k4_into_k2(rand(5, h, w), rand(5, h, w), dx, dy, win, gauss, f"{h}x{w}")


def slice_phase(dev, h: int, w: int) -> None:
    """The slice on the card (kernels) against the CPU (plain versions)."""
    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

    cfg = config(h, w, max_cells=1024)
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
    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config, timed_sweep
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

    cfg = config(h, w)
    bevs = [torch.as_tensor(f, device=dev) for f in make_frames(n_frames, h, w)]
    pipe = PipelineA(cfg, dev, fast_warp=True)
    carry = pipe.init_stream_carry()  # warm-up, not counted
    torch.cuda.set_sync_debug_mode("error")  # a step that waits for the device raises
    for f in bevs[:2]:
        carry, _ = pipe.step_stream(f, carry)
    torch.cuda.set_sync_debug_mode("default")
    log("warm-up steps: no host synchronisation (torch.cuda.set_sync_debug_mode)")
    torch.cuda.synchronize()

    reset_launches()
    elapsed, carry, out = timed_sweep(pipe, bevs)  # the benchmark's sweep: prime, then steps
    launches = read_launches()
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

def gmfa_preprocess_phase(dev, pipe, frames, n_check: int = 3) -> list:
    """GMFA's ``preprocess`` on the card: its first call with synchronising
    CUDA operations turned into errors, then every frame of ``frames``
    (padded numpy points, ``benchmarks/gmfa_reference_load``'s keys), the
    first ``n_check`` held to the CPU port's bit for bit (``torch.equal``),
    with float32 and with q16 points.  Returns the card's clouds."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import gmfa_reference_load as grl
    from datmo_using_optical_flow_tpu_torch.io.frames import pad_points_q16
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline

    cpu = GMFAPipeline(pipe.cfg, pipe.max_moving, "cpu")
    first = [torch.from_numpy(a).to(dev) for a in frames[0]] + [grl.frame_key(0, dev)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # preprocess must not wait for the card
    try:
        pipe.preprocess(*first)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("GMFA preprocess warm-up: no host synchronisation (torch.cuda.set_sync_debug_mode)")
    clouds = grl.clouds(pipe, frames)
    cap = pipe.cfg.capacities.max_raw_points
    for q16 in (False, True):
        for i in range(n_check):
            pts, mask = frames[i]
            if q16:
                pts, mask = pad_points_q16(pts[mask], cap)
            t0 = time.perf_counter()
            want = cpu.preprocess(torch.from_numpy(pts), torch.from_numpy(mask),
                                  grl.frame_key(i, "cpu"))
            cpu_s = time.perf_counter() - t0
            got = (pipe.preprocess(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev),
                                   grl.frame_key(i, dev)) if q16 else clouds[i])
            got = tuple(t.cpu() for t in got)
            rows = int((got[0] != want[0]).any(dim=1).sum())
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            log(f"GMFA preprocess frame {i} ({'q16' if q16 else 'float32'}): card "
                f"{'equals' if same else 'DIFFERS FROM'} the CPU bit for bit ({rows} of "
                f"{int(want[1].sum())} expanded rows differ; CPU preprocess {cpu_s:.2f} s)")
            if not same or int(want[1].sum()) == 0:
                raise AssertionError(f"GMFA preprocess frame {i}: the card differs from the CPU")
    return clouds


def _k5_equal(label: str, got, want) -> None:
    """Raise unless the kernel's five outputs equal the plain version's, bit
    for bit."""
    names = ("idx", "d2", "lo", "d2nd", "coords")
    bad = {n: int((g != w).sum()) for n, g, w in zip(names, got, want) if not torch.equal(g, w)}
    if bad:
        raise AssertionError(f"K5 {label}: differs from the serial plain version {bad}")


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


def nn_cases(dev, pair, icp_cfg):
    """K5's inputs at GMFA's reference load: (label, src, index, keyword
    arguments of ``nearest_neighbors``, rows owed a result, target, target
    mask).  Uncapped and with the classification cap (Morton-sorted sources,
    as the classification sweep and ICP's final evaluation give them), an
    ICP-style ~13% active subset partitioned to the front, every target twice
    (so every row's minimum is tied), and the inputs ICP's busiest active
    round gave K5 on this frame pair (recorded around its active query)."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import icp_body
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5

    (prev, prev_m), (cur, cur_m) = pair
    index = k5.build_target_index(cur, cur_m)
    order = k5.sort_order(prev, prev_m).long()
    src, src_valid = prev[order].contiguous(), prev_m[order]
    cls_cap2 = float(np.float32(1.2) * np.float32(1.2))
    icp_cap2 = float(np.float32(0.1) * np.float32(0.1))
    gen = torch.Generator(device=dev).manual_seed(3)
    active = src_valid & (torch.rand(src.shape[0], generator=gen, device=dev) < 0.13)
    part = torch.cat([torch.nonzero(active)[:, 0], torch.nonzero(~active)[:, 0]])
    src_c = src[part].contiguous()
    n_act = int(active.sum())
    half = cur.shape[0] // 2
    dup, dup_m = torch.cat([cur[:half], cur[:half]]), torch.cat([cur_m[:half], cur_m[:half]])
    _, rounds, busiest = icp_body.record_icp_rounds(prev, prev_m, cur, cur_m, icp_cfg.threshold,
                                                    icp_cfg.max_iterations)
    rp = icp_body.round_inputs(rounds[busiest])
    r_act = int(rp.block_counts.sum())
    every = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    return [("uncapped", src, index, {}, src_valid, cur, cur_m),
            ("capped (2*0.6)^2", src, index, {"cap2": cls_cap2}, src_valid, cur, cur_m),
            (f"active {n_act}/{src.shape[0]} cap (5*0.02)^2", src_c, index,
             {"n_active": n_act, "cap2": icp_cap2, "block_table": k5.build_block_table(src_c, index)},
             torch.arange(src.shape[0], device=dev) < n_act, cur, cur_m),
            ("every target twice (tied minima)", src, k5.build_target_index(dup, dup_m), {},
             src_valid, dup, dup_m),
            (f"ICP round {busiest} ({r_act} active rows)", rp.src, rp.index,
             {"n_active": r_act, "cap2": float(rp.cap2[0])},
             torch.arange(rp.src.shape[0], device=dev) < r_act, cur, cur_m)]


def nn_phase(dev, name: str, smi: str, cases) -> dict:
    """K5 against its serial plain version (bit-equal) on ``cases``, at each
    cluster size and at the source's, with its bounds checked sound; device
    µs per cluster size; per-call ms of the wrapper and the plain version,
    timed as in phase 3; the tiles each block visits (read from the plain
    sweep) and the bounds they set."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.diagnostics.measure import device_us_per_call
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5

    res = {"max_abs_err": 0.0, "cases": []}
    for i, (label, s, index, kw, rows, tgt, tgt_m) in enumerate(cases):
        p = k5.prepare(s, index, **kw)
        active = "n_active" in kw  # as the wrapper chooses the kept size
        want, visits = k5._sweep_reference(p)
        got = k5._sweep_kernel(p, active=active)
        torch.cuda.synchronize()
        _k5_equal(label, got, want)
        n = s.shape[0]
        _nn_sound(label, s, tgt, tgt_m, got[2][:n], got[3][:n], rows, seed=i)
        live = visits[visits > 0].to(torch.float64)
        vmax = int(live.max())
        work = roofline.nearest_neighbors(n, index.packed.shape[0] * k5.TGT_TILE,
                                          int(live.sum()), live.numel())
        log(f"K5 {label}: bit-equal to the serial plain version (max_abs_err 0.0, 0 idx "
            f"mismatches); tiles visited per live block mean {float(live.mean()):.2f}, median "
            f"{float(live.median()):.1f}, max {vmax} of {index.packed.shape[0]} "
            f"({live.numel()} live blocks); {work.ops / 1e9:.3f} Gop, bound "
            f"{work.bound_us():.3f} us ({work.bound_by()}), busiest block's serial bound "
            f"{roofline.nearest_neighbors_serial_us(vmax):.3f} us on one SM")
        per_c = {}
        for c in k5.CLUSTER_SIZES:
            _k5_equal(f"{label} C={c}", k5._sweep_kernel(p, c), want)
            per_c[c] = device_us_per_call(lambda: k5._sweep_kernel(p, c), dev, reps=3)
            log(f"K5 {label} C={c}: bit-equal, device {per_c[c]:.1f} us, busiest block's serial "
                f"bound {roofline.nearest_neighbors_serial_us(vmax, c):.3f} us "
                f"[{name}, {smi}]")
        kept_us = device_us_per_call(lambda: k5._sweep_kernel(p, active=active), dev, reps=3)
        row = {"label": label, "device_us": per_c, "kept_us": kept_us,
               "bound_us": work.bound_us(), "visits_max": vmax}
        if i != 3:  # the tie case is a check, not a shape of the path
            ms, plain_ms = time_pair(lambda: k5.nearest_neighbors_reference(s, index, **kw),
                                     lambda: k5.nearest_neighbors(s, index, **kw),
                                     rounds=3, warmup=1)
            row.update(ms=ms, plain_ms=plain_ms)
            log(f"K5 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (incl. the "
                f"block table), kernel device {kept_us:.1f} us [{name}, {smi}]")
        res["cases"].append(row)
        if i == 0:
            res["ms"], res["plain_ms"], res["work"] = row["ms"], row["plain_ms"], work
    return res


def k5_step_phase(dev, name: str, smi: str, pipe, clouds) -> dict:
    """K5's device ms per GMFA step, full and active sweeps apart, at the
    source's cluster size and at each size: the step on frame 1 after
    ``seed_carry`` on frame 0, with every K5 call's inputs recorded, then the
    recorded sweeps replayed under the profiler."""
    from unittest import mock

    from datmo_using_optical_flow_tpu_torch.diagnostics.measure import device_us_per_call
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5
    from datmo_using_optical_flow_tpu_torch.utils import prng

    calls = []
    original = k5.nearest_neighbors

    def recorder(src, index, n_active=None, cap2=None, block_counts=None, block_table=None,
                 drift=None):
        p = k5.prepare(src, index, n_active, cap2, block_counts, block_table, drift)
        calls.append((p, n_active is not None or block_counts is not None))
        return original(src, index, n_active, cap2, block_counts, block_table, drift)

    carry = pipe.seed_carry(*clouds[0])
    with mock.patch.object(k5, "nearest_neighbors", recorder):
        pipe.step(*clouds[1], carry, prng.PRNGKey(0))
    torch.cuda.synchronize()
    groups = {"full": [p for p, a in calls if not a], "active": [p for p, a in calls if a]}

    def step_ms(cluster) -> dict:
        out = {}
        for g, ps in groups.items():
            out[g] = device_us_per_call(
                lambda: [k5._sweep_kernel(p, cluster, g == "active") for p in ps], dev,
                reps=1) / 1e3
        out["total"] = out["full"] + out["active"]
        return out

    res = {"kept": step_ms(None)}
    for c in k5.CLUSTER_SIZES:
        res[c] = step_ms(c)
    for key, ms in res.items():
        log(f"K5 per GMFA step ({len(groups['full'])} full + {len(groups['active'])} active "
            f"sweeps), {'kept cluster size' if key == 'kept' else f'C={key}'}: device "
            f"{ms['total']:.3f} ms (full {ms['full']:.3f}, active {ms['active']:.3f}) "
            f"[{name}, {smi}]")
    return res


def gmfa_slice_phase(dev) -> None:
    """A small GMFA configuration on the card (kernels) against the CPU (plain
    versions), on the same clouds (preprocessed by the port on the CPU) and
    step keys."""
    from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig,
                                                           GMFAConfig, IcpConfig)
    from datmo_using_optical_flow_tpu_torch.io.frames import pad_points
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow_tpu_torch.sim import synthetic as synth
    from datmo_using_optical_flow_tpu_torch.utils import prng

    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30), icp=IcpConfig(threshold=0.2),
                     capacities=CapacityConfig(max_raw_points=8192, max_roi_points=512,
                                               max_cells=1024, max_clusters=8, max_tracks=16))
    scene = synth.SyntheticScene(seed=33, targets=(
        synth.BoxTarget(center0=(5.0, -4.0, 0.75), velocity=(1.5, 0.8), points_per_frame=300),
        synth.BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
                        points_per_frame=250)))
    gpipe, cpipe = GMFAPipeline(cfg, 2048, dev), GMFAPipeline(cfg, 2048, "cpu")
    clouds = []
    for i in range(4):  # frames 1 s apart, as tests/test_torch_gmfa_pipeline.py makes them
        pts, mask = pad_points(synth.synthetic_frame(scene, i).astype(np.float32),
                               cfg.capacities.max_raw_points)
        clouds.append(cpipe.preprocess(torch.from_numpy(pts), torch.from_numpy(mask),
                                       prng.fold_in(prng.PRNGKey(17), i)))
    gc = gpipe.seed_carry(clouds[0][0].to(dev), clouds[0][1].to(dev))
    cc = cpipe.seed_carry(*clouds[0])
    for i in range(1, len(clouds)):
        key = prng.split(prng.fold_in(prng.PRNGKey(5), i))[1]
        gc, go = gpipe.step(clouds[i][0].to(dev), clouds[i][1].to(dev), gc, key)
        cc, co = cpipe.step(*clouds[i], cc, key)
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


def gmfa_main_path(dev, name: str, smi: str, pipe, clouds) -> tuple[dict, dict]:
    """``benchmarks/gmfa_reference_load``'s workload through the port:
    seed_carry, then one step per later cloud (102,400 expanded points each,
    preprocessed by the port on the card), keyed as the benchmark keys its
    first sweep; then K5's device ms per step (:func:`k5_step_phase`).
    Returns the launches and those ms."""
    from datmo_using_optical_flow_tpu_torch.ops import icp as icp_ops
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5
    from datmo_using_optical_flow_tpu_torch.utils import prng

    cfg = pipe.cfg
    n_frames = len(clouds)
    keys = [prng.fold_in(prng.PRNGKey(0), 100 + i) for i in range(n_frames)]
    log(f"GMFA clouds: {n_frames} x {clouds[0][0].shape[0]} expanded points, valid "
        f"{[int(m.sum()) for _, m in clouds]} (the port's preprocess)")

    # warm-up (not counted): the first steps, with every host synchronisation
    # recorded through torch.cuda.set_sync_debug_mode
    carry = pipe.seed_carry(*clouds[0])
    syncs = []
    for i in (1, 2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                carry, out = pipe.step(*clouds[i], carry, keys[i])
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
        carry, out = pipe.step(*clouds[i], carry, keys[i])
        outs.append(out)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = k5.LAUNCHES["nearest_neighbors"]
    steps = n_frames - 1
    for i, o in enumerate(outs, start=1):
        log(f"GMFA frame {i}: skip {bool(o.skip)}, moving {int(o.moving_count)} (cap "
            f"{pipe.max_moving}{', hit' if int(o.moving_count) >= pipe.max_moving else ''}), "
            f"clusters {int(o.n_clusters)}, fitness {float(o.fitness):.6f}, |T - I| "
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
        f"live tracks {alive}, track ids {sorted(carry.table.tid[carry.table.alive].tolist())} "
        f"[{name}, {smi}]")
    finite = all(bool(torch.isfinite(t).all()) for o in outs
                 for t in (o.transformation, o.fitness, o.residuals))
    finite = finite and bool(torch.isfinite(carry.table.state).all())
    if not finite or launches <= 0 or sum(int(o.moving_count) for o in outs) <= 0:
        raise AssertionError(f"GMFA outputs: finite={finite} launches={launches}")
    return {"nearest_neighbors": launches}, k5_step_phase(dev, name, smi, pipe, clouds)


def gmfa_files_phase(dev, name: str, smi: str, root: str) -> None:
    """GMFA from PCD files at a small configuration: ``process_files`` over 4
    ``synth`` frames on the card and on the CPU (rows: the same count,
    frames and track ids, states within the CPU tests' 1e-4 + 1e-5 relative,
    the SOM within 1e-6), and the card's run resumed from its checkpoint
    after frame 2, which gives the same rows for frame 3."""
    from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig,
                                                           GMFAConfig, IcpConfig, RansacConfig)
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow_tpu_torch.sim import synthetic as synth

    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=20), icp=IcpConfig(threshold=0.2),
                     ransac=RansacConfig(num_iterations=300),
                     capacities=CapacityConfig(max_raw_points=4096, max_roi_points=384,
                                               max_cells=1024, max_clusters=8, max_tracks=16))
    scene = synth.SyntheticScene(ground_points=2500, ground_extent=10.0, seed=21, targets=(
        synth.BoxTarget(center0=(-3.0, -2.0, 0.75), velocity=(0.6, 0.3), points_per_frame=150),
        synth.BoxTarget(center0=(3.0, 2.5, 0.75), velocity=(-0.4, -0.45), size=(3.0, 1.6, 1.4),
                        points_per_frame=150)))
    paths = synth.write_synthetic_sequence(scene, os.path.join(root, "gmfa_seq"), 4)
    ckpt = os.path.join(root, "gmfa_state.npz")
    t0 = time.perf_counter()
    card = GMFAPipeline(cfg, 1024, dev).process_files(paths, checkpoint_every=3,
                                                       checkpoint_path=ckpt)
    cpu = GMFAPipeline(cfg, 1024, "cpu").process_files(paths)
    resumed = GMFAPipeline(cfg, 1024, dev).process_files(paths, checkpoint_path=ckpt,
                                                          resume=True)

    def ids(rows):
        return [(r["Frame"], r["Track ID"]) for r in rows]

    def states(rows):
        return np.array([[r[c] for c in ("X", "Y", "VX", "VY")] for r in rows], np.float64)

    same_ids = ids(card["rows"]) == ids(cpu["rows"]) and len(cpu["rows"]) > 0
    close = same_ids and np.allclose(states(card["rows"]), states(cpu["rows"]), atol=1e-4,
                                     rtol=1e-5)
    serr = float(np.abs(states(card["rows"]) - states(cpu["rows"])).max()) if same_ids else None
    som_err = float(np.abs(card["som"] - cpu["som"]).max())
    tail = [r for r in card["rows"] if r["Frame"] >= 2]
    log(f"GMFA process_files, 4 frames, card vs CPU: rows {len(card['rows'])}/{len(cpu['rows'])}, "
        f"frames and ids {'equal' if same_ids else 'DIFFER'}, state max_abs_err {serr} (tol "
        f"1e-4 + 1e-5 rel), SOM max_abs_err {som_err:.3e} (tol 1e-6); resumed at frame 3: "
        f"{'same rows' if resumed['rows'] == tail else 'DIFFERENT rows'}; card stages (host s) "
        f"{card['timings']}; {time.perf_counter() - t0:.1f} s [{name}, {smi}]")
    if not close or som_err > 1e-6 or not tail or resumed["rows"] != tail:
        raise AssertionError("GMFA process_files: the card disagrees with the CPU or its resume")


def diagnostics_phase(dev, gmfa_cfg, pair) -> dict:
    """This slice's path: the diagnostics at full size, each with every launch
    count set to 0 just before it and read just after.  Returns each kernel's
    launches over the runs that must launch it."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import icp_body, micro_flow, profile_1080p
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames

    frames = make_frames(2, 1080, 1920, seed=0)
    flow = ("poly_exp", "blur_solve", "fused_iteration", "warp_matrices")
    runs = (("micro_flow", lambda: micro_flow.run(frames, dev), flow),
            ("profile_1080p", lambda: profile_1080p.run(frames, dev), flow),
            ("icp_body", lambda: icp_body.run(
                *icp_body.clouds(102400), dev, probe=pair, threshold=gmfa_cfg.icp.threshold,
                max_iterations=gmfa_cfg.icp.max_iterations), ("nearest_neighbors", "tiny")))
    launches = {}
    for label, fn, kernels in runs:
        t0 = time.perf_counter()
        reset_launches()
        res = fn()
        counts = read_launches()
        log(f"diagnostics.{label}: launches {counts}, {time.perf_counter() - t0:.1f} s")
        missing = [k for k in kernels if counts[k] <= 0]
        timings = [v for r in res["rows"] for k, v in r.items() if k.startswith(("ms", "device"))]
        if missing or not all(v is not None and np.isfinite(v) and v > 0 for v in timings):
            raise AssertionError(f"diagnostics.{label}: kernels {missing} not launched, or a "
                                 f"time is missing")
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
    tiles = res["tile_probe"]["rounds"]
    if "active" not in tiles or tiles["first"]["visits_total"] <= 0:
        raise AssertionError(f"icp_body tile probe: {tiles}")
    return launches


# ------------------------------------------------------------------ pipeline A from points

def from_points_k1_k2(dev, name: str, smi: str, bevs, c) -> dict:
    """K1 and K2 at the from-points levels (200x200 and 60x60) against their
    plain versions, bit for bit, on two consecutive BEVs of the run; each
    timed (per call, device µs) beside its bound, K1 also beside
    ``F.conv2d``.  K2's M comes from the two frames' pyramids at zero flow;
    ``c`` is the Farnebäck configuration."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.diagnostics.measure import device_us_per_call
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    full = bevs[0].to(torch.float32)
    pyr = [fb.build_pyramid(b.to(torch.float32), c.pyr_scale, c.levels, c.poly_n, c.poly_sigma)
           for b in bevs[:2]]
    top = len(pyr[0]) - 1
    rows = {"poly_exp": {}, "blur_solve": {}}
    for level in range(top, -1, -1):
        lh, lw = pyr[0][level].shape[1:]
        label = f"{lh}x{lw}"
        img = fb.level_image(full, c.pyr_scale ** (top - level), lh, lw).contiguous()
        want = fk.poly_exp_reference(img, c.poly_n, c.poly_sigma)
        err = check("poly_exp", f"from points {label}", fk.poly_exp(img, c.poly_n, c.poly_sigma),
                    want)
        ms, plain_ms = time_pair(lambda: fk.poly_exp_reference(img, c.poly_n, c.poly_sigma),
                                 lambda: fk.poly_exp(img, c.poly_n, c.poly_sigma))
        us = device_us_per_call(lambda: fk.poly_exp(img, c.poly_n, c.poly_sigma), dev)
        lib_ms = library_phase("poly_exp", f"from points {label}",
                               poly_exp_conv(img, c.poly_n, c.poly_sigma), want,
                               1e-3 * float(want.abs().max()), dev, name, smi)
        bound = roofline.poly_exp(lh, lw, c.poly_n, c.poly_sigma).bound_us()
        rows["poly_exp"][label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us,
                                   "library_ms": lib_ms, "bound_us": bound, "max_abs_err": err}
        log(f"poly_exp from points {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device "
            f"{us:.1f} us, bound {bound:.3f} us, share {bound / us:.3f}, F.conv2d {lib_ms:.4f} "
            f"ms [{name}, {smi}]")
        R0, R1 = pyr[0][level], pyr[1][level]
        zero = torch.zeros((lh, lw), dtype=torch.float32, device=dev)
        M = fb.update_matrices(R0, R1, zero, zero, fb.pack_corner_pairs(R1))
        want = fk.blur_solve_reference(M, c.winsize, False)
        err = check("blur_solve", f"from points {label}", fk.blur_solve(M, c.winsize, False), want)
        ms, plain_ms = time_pair(lambda: fk.blur_solve_reference(M, c.winsize, False),
                                 lambda: fk.blur_solve(M, c.winsize, False))
        us = device_us_per_call(lambda: fk.blur_solve(M, c.winsize, False), dev)
        bound = roofline.blur_solve(lh, lw, c.winsize).bound_us()
        rows["blur_solve"][label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us,
                                     "library_ms": None, "bound_us": bound, "max_abs_err": err}
        log(f"blur_solve from points {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"device {us:.1f} us, bound {bound:.3f} us, share {bound / us:.3f} [{name}, {smi}]")
    return rows


def from_points_phase(dev, name: str, smi: str, root: str, n_frames: int = 12
                      ) -> tuple[dict, dict]:
    """Pipeline A from PCD files at the reference's production shape
    (``benchmarks/from_points.py``: 65,536 raw points, 5000 RANSAC
    hypotheses, a 200x200 BEV): the preprocess warm-up with synchronising
    CUDA operations turned into errors; the card's BEV against the CPU's, bit
    for bit, on the first 3 frames; K1 and K2 at both levels; then
    ``process_files`` over ``n_frames`` frames with float32 and with q16
    points, each with the launch counts set to 0 just before and read just
    after; the card's 4-frame run against the CPU's.  Returns the launches
    and K1/K2's rows."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import from_points as fpb
    from datmo_using_optical_flow_tpu_torch.io.frames import DiskFrameSource
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.sim.synthetic import write_synthetic_sequence
    from datmo_using_optical_flow_tpu_torch.utils import prng

    cfg = fpb.config()
    t0 = time.perf_counter()
    paths = write_synthetic_sequence(fpb.scene(), os.path.join(root, "seq"), n_frames)
    frames = list(DiskFrameSource(paths[:3], capacity=cfg.capacities.max_raw_points))
    log(f"from points: {n_frames} frames written ({int(frames[0][1].sum())} raw points in "
        f"frame 0) in {time.perf_counter() - t0:.2f} s")
    keys = [prng.fold_in(prng.PRNGKey(0), i) for i in range(3)]
    inputs = [(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev), k.to(dev))
              for (p, m), k in zip(frames, keys)]
    pipe, cpu = PipelineA(cfg, dev), PipelineA(cfg, "cpu")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # preprocess and step must not wait for the card
    try:
        carry = pipe.init_stream_carry()
        for x in inputs[:2]:
            carry, _ = pipe.step_stream(pipe.preprocess(*x), carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("from points warm-up: preprocess and steps ran with no host synchronisation")

    bevs = []
    for i, ((p, m), k) in enumerate(zip(frames, keys)):
        t0 = time.perf_counter()
        want = cpu.preprocess(torch.from_numpy(p), torch.from_numpy(m), k)
        cpu_s = time.perf_counter() - t0
        got = pipe.preprocess(*inputs[i])
        bevs.append(got)
        same = torch.equal(got.cpu(), want)
        log(f"from points frame {i}: card BEV {'equals' if same else 'DIFFERS FROM'} the CPU's "
            f"bit for bit ({int((got.cpu() != want).sum())} cells differ, {int((want > 0).sum())} "
            f"nonzero; CPU preprocess {cpu_s:.2f} s)")
        if not same or int((want > 0).sum()) == 0:
            raise AssertionError(f"from points frame {i}: card BEV differs from the CPU's")
    rows = from_points_k1_k2(dev, name, smi, bevs, cfg.farneback)

    launches = {}
    for q16 in (False, True):
        label = "q16" if q16 else "float32"
        reset_launches()
        t0 = time.perf_counter()
        summary = pipe.process_files(paths, output_dir=os.path.join(root, f"out_{label}"),
                                     h2d_q16=q16)
        elapsed = time.perf_counter() - t0
        counts = read_launches()
        per = {k: v / n_frames * 1e3 for k, v in summary["timings"].items()}
        log(f"from points process_files ({label}): {n_frames} frames, {summary['pairs']} pairs, "
            f"{len(summary['tracks'])} tracks, {n_frames / elapsed:.3f} frames/s "
            f"({elapsed / n_frames * 1e3:.3f} ms/frame; runner stages, ms/frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
            + f"), launches {counts} [{name}, {smi}]")
        want = {"poly_exp": 2 * n_frames, "blur_solve": 10 * n_frames}
        finite = all(np.isfinite(st).all() for st in summary["tracks"].values())
        if summary["pairs"] != n_frames - 1 or not summary["tracks"] or not finite:
            raise AssertionError(f"from points ({label}): a frame was skipped, or no finite "
                                 f"track came out ({summary['pairs']} pairs)")
        if {k: counts[k] for k in want} != want or any(
                v for k, v in counts.items() if k not in want):
            raise AssertionError(f"from points ({label}): launches {counts}, expected {want}")
        for k in want:
            launches[k] = launches.get(k, 0) + counts[k]

    # the card's run against the CPU's on the first 4 frames (the tests' tolerances)
    t0 = time.perf_counter()
    cdir, gdir = os.path.join(root, "cpu4"), os.path.join(root, "card4")
    csum = cpu.process_files(paths[:4], output_dir=cdir)
    gsum = pipe.process_files(paths[:4], output_dir=gdir)
    if sorted(os.listdir(cdir)) != sorted(os.listdir(gdir)):
        raise AssertionError("from points: the card and the CPU wrote different files")
    verr = 0.0
    for i in range(4):
        for f in ("bev_frame_%d.npy",) + (("dbscan_labels_frame_%d.npy",
                                           "dbscan_indices_frame_%d.npy") if i < 3 else ()):
            if not np.array_equal(np.load(os.path.join(cdir, f % i)),
                                  np.load(os.path.join(gdir, f % i))):
                raise AssertionError(f"from points: {f % i} differs between card and CPU")
        if i < 3:
            for f in ("velocity_x_frame_%d.npy", "velocity_y_frame_%d.npy"):
                verr = max(verr, float(np.abs(np.load(os.path.join(cdir, f % i))
                                              - np.load(os.path.join(gdir, f % i))).max()))
    same_ids = set(gsum["tracks"]) == set(csum["tracks"])
    terr = max((float(np.abs(gsum["tracks"][t] - s).max()) for t, s in csum["tracks"].items()
                if same_ids), default=0.0)
    log(f"from points, 4 frames, card vs CPU: BEVs and DBSCAN files equal, velocity max_abs_err "
        f"{verr:.3e} (tol 1e-4), tracks {sorted(gsum['tracks'])}/{sorted(csum['tracks'])}, "
        f"state max_abs_err {terr:.3e} (tol 5e-3); {time.perf_counter() - t0:.1f} s")
    if verr > 1e-4 or not same_ids or terr > 5e-3:
        raise AssertionError("from points: the card's 4-frame run disagrees with the CPU's")
    return launches, rows


def benchmarks_phase() -> dict:
    """The port's three benchmarks once each, shortened (9 frames and 1 sweep
    at 1080x1920, 6 frames from points, 4 GMFA frames and 1 sweep), each run
    as a user runs it: its own
    process (``python -m``), whose last line of output is its JSON record.
    A fresh process also keeps the benchmark's profiler traces out of this
    long one (late in it, traces have lost their first records)."""
    out = {}
    pkg = "datmo_using_optical_flow_tpu_torch.benchmarks"
    for label, args in (("stream_1080p", ["--frames", "9", "--sweeps", "1"]),
                        ("from_points", ["--frames", "6"]),
                        ("gmfa_reference_load", ["--frames", "4", "--sweeps", "1"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.{label}", *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"benchmarks.{label} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"benchmarks.{label} (shortened, {time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(rec)}")
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"benchmarks.{label}: no rate")
        out[label] = rec
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    sys.path.insert(0, ROOT)
    from datmo_using_optical_flow_tpu_torch.benchmarks import gmfa_reference_load as grl
    from datmo_using_optical_flow_tpu_torch.kernels import build
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline

    t_start = time.perf_counter()
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
    results["tiny"] = probe_phase(dev, name, smi)
    other_shapes_phase(dev)
    slice_phase(dev, 256, 320)
    n_frames = 25
    launches = main_path(dev, name, smi, 1080, 1920, n_frames)
    by_path = {"stream_1080p": dict(launches)}
    want = {k: PER_STEP.get(k, 0) * n_frames for k in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    gcfg = grl.config()
    gpipe = GMFAPipeline(gcfg, grl.MAX_MOVING, dev)
    t0 = time.perf_counter()
    gclouds = gmfa_preprocess_phase(dev, gpipe, grl.raw_frames(gcfg, grl.scene(), grl.N_FRAMES))
    log(f"GMFA preprocess phase: {time.perf_counter() - t0:.1f} s")
    pair = gclouds[:2]
    results["nearest_neighbors"] = nn_phase(dev, name, smi, nn_cases(dev, pair, gcfg.icp))
    gmfa_slice_phase(dev)
    k5_launches, k5_step_ms = gmfa_main_path(dev, name, smi, gpipe, gclouds)
    launches.update(k5_launches)
    diag = diagnostics_phase(dev, gcfg, (*pair[0], *pair[1]))
    by_path.update(gmfa=k5_launches, diagnostics=diag)
    launches.update({k: diag[k] for k in ("warp_matrices", "tiny")})
    with tempfile.TemporaryDirectory() as root:
        fp_launches, fp_rows = from_points_phase(dev, name, smi, root)
        gmfa_files_phase(dev, name, smi, root)
    benchmarks_phase()
    by_path["from_points"] = fp_launches
    for k, v in fp_launches.items():
        launches[k] += v
    results["poly_exp"]["levels"].update(fp_rows["poly_exp"])
    results["blur_solve"]["levels"] = fp_rows["blur_solve"]
    for k, rows in fp_rows.items():
        results[k]["max_abs_err"] = max([results[k]["max_abs_err"]]
                                        + [r["max_abs_err"] for r in rows.values()])

    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline

    work = {"poly_exp": roofline.poly_exp(1080, 1920), "blur_solve": roofline.blur_solve(97, 173),
            "fused_iteration": roofline.fused_iteration(1080, 1920),
            "warp_matrices": roofline.warp_matrices(1080, 1920),
            "nearest_neighbors": results["nearest_neighbors"]["work"],
            "tiny": roofline.tiny(8 * 128)}
    kernels = []
    for k in REPLACES:
        res, bound_us = results[k], work[k].bound_us()
        if launches[k] <= 0:
            raise AssertionError(f"{k}: not launched on its path")
        kernels.append({"name": k, "route": "cuda",
                        "source": f"datmo_using_optical_flow_tpu_torch/csrc/{SOURCES[k]}",
                        "replaces": REPLACES[k], "launches": launches[k],
                        "launches_by_path": {p: c[k] for p, c in by_path.items() if c.get(k)},
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"], "bound_ms": bound_us / 1e3,
                        "bound_us": bound_us, "bound_by": work[k].bound_by(),
                        "library_ms": res.get("library_ms"), "lib_ms": res.get("library_ms")})
        if k == "nearest_neighbors":  # its time per GMFA step, by cluster size
            kernels[-1]["device_ms_per_step"] = {str(c): v for c, v in k5_step_ms.items()}
        if k in ("poly_exp", "blur_solve", "fused_iteration"):  # times at each level that runs it
            kernels[-1]["levels"] = res["levels"]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
