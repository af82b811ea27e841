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
6. the main path: pipeline A's stream step on 25 ``bench.make_frames``
   1080x1920 frames with ``bench.py``'s configuration, counting each kernel's
   launches, and frames/s over the 24 steps after the priming frame; the
   warm-up steps run with synchronising CUDA operations turned into errors.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "poly_exp": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:194",
    "blur_solve": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:78",
    "fused_iteration": "datmo_using_optical_flow_tpu/ops/flow_pallas.py:435",
}
PER_STEP = {"poly_exp": 3, "fused_iteration": 10, "blur_solve": 5}  # 1080p, 3 levels
TOL = {"poly_exp": 1e-5, "blur_solve": 1e-4, "fused_iteration": 2e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_pair(plain, kernel, rounds: int = 10) -> tuple[float, float]:
    """Median ms per call of (kernel, plain): CUDA events around each call,
    calls in turns plain, kernel, kernel, plain (2 * rounds calls each)."""
    fns = {"plain": plain, "kernel": kernel}
    times = {"plain": [], "kernel": []}
    for _ in range(3):
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

    kernels = [{"name": k, "route": "cuda",
                "source": "datmo_using_optical_flow_tpu_torch/csrc/flow_kernels.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
                "plain_ms": results[k]["plain_ms"]} for k in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
