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
   path's shapes, K1-K4 and K9 bit for bit (``torch.equal``), the others
   as their phases below say, and both timed (CUDA events, median of 20
   calls each, in turns plain, kernel, kernel, plain); K1 at all three
   pyramid levels and K3 at both levels that run it also by their device
   µs; K9 (the packed warp, which quantises its corners from R1) and K2 at
   the coarsest level, K2, K3 and K9 also with the flow as the main path
   carries it (the upsampled flow times 1 / pyr_scale, the solve's numerators
   and 1 / det); K9's scale pass there beside ``torch.amax``; K9 and its
   scale pass also as int32 bits at 5x122, 1x173, 97x1 (zero, 1.5 px, 6 px
   and the carried flow), with an all-zero R1 plane, with corners in
   (-scale / 2, 0) over R0 of -0.0, and at 1080x1920; K4 with the converged
   flow of two 1080x1920 frames, and K4 into K2
   bit-equal to K3 there; K1 (at each level) and K6 also beside one PyTorch
   call of the same function (``F.conv2d``, ``torch.add``), timed and not
   used by the port; K6's launch path split into its parts, each timed over
   1,000 calls;
3b. K8 (the level images and the flow's upsample, ``ops/level_kernels``)
   ``torch.equal`` to its plain version: each frame's level images in one
   launch (the 1080p, from-points, 4K and 720p pyramids), every level image
   alone (one launch each; level 0's blur included, 3 to 91 taps) and the
   upsample of each level transition in the main path's form (two planes,
   scale 1.0), each timed (per call, device µs, bound) beside its plain
   version and one PyTorch composition of the same function (the pyramid:
   the sum of each level's separable ``F.conv2d`` and ``F.interpolate``; the
   upsample: ``F.interpolate`` of the stacked flow), within 1e-3 of the
   scale; the general form (a stack times 1 / pyr_scale) ``torch.equal``
   too; the upsample's host launch path split into its parts; every counted
   path below checks K8's launches exactly (one per frame's level images,
   one per upsample);
4. the same at the CPU tests' other shapes and options (untimed): K1 at
   ragged shapes with poly_n 5 and 7, through both of its tile heights and
   both of its C paths (a sigma of 0.3 takes the runtime-n kernel), K4 at
   160x384, 130x384 and 160x1920 and K4 into K2 bit-equal to K3 at the
   shapes of ``tests/test_flow_pallas.py``; K4 at tiny levels (2x2 ... 4x4,
   1x4, 2x64, 64x2, 3x40, 40x3, ...: its instance for a one-valued
   attenuation) with a given, a scalar-scaled and a plane-scaled flow, and
   K2's Gaussian window there at winsizes 15 and 5 (its broadcast taps),
   ``torch.equal`` to their plain versions; K8 at the edge shapes (one row,
   one column, 1x1, a radius past the axis: 3x200 at 25 taps, 64x1 at 7),
   the blur and a three-level pyramid in one launch each, ``torch.equal``;
4b. K1's narrow form (``w + n < 128``, where XLA rounds the y^2 plane
   otherwise): both CUDA instances ``torch.equal`` to the plain version at
   the pipelines' narrow levels (60x60, 65x115, 59x104) and on both sides of
   the boundary, at sigma 5.0 and 1.1, at 0.3 across the boundary and at
   n = 7; K1's tiny form (at most n rows or columns, ``ops/poly_tiny``)
   ``torch.equal`` to the plain version in 57 tiny cases (5x122 ... 1x1,
   122x5, 1088x5, 200x3, 5x5, the shapes of ROADMAP Queue 3 item 8; n = 5
   and 7; the compile-time and the runtime-n taps); K1 at the sharded
   flow's 282x1920 block timed beside
   ``F.conv2d``;
4c. the small exact-warp levels' route through K3 (``ops/warp.exact_fused``):
   at 60x60, 97x173, 98x173 and 200x200, box and Gaussian window, zero flow,
   a given flow and that flow times 1 / pyr_scale, each of 5 iterations of K3
   and the whole level ``torch.equal`` to the plain version, the level
   counted alone (5 K3 launches, no K4 or K2), the box level with zero flow
   timed; at the route's edges (lines, levels of at most 4x4, a Gaussian
   window with an axis within its radius, and just past them) the
   predicate held to ``datmo_fused_iteration``, which takes exactly the
   levels it admits, and each level (3 iterations) counted and equal to its
   plain version;
5. the 256x320 slice on the card (kernels) against the CPU (plain versions);
6. pipeline A's main path: the stream step on 25 ``make_frames`` 1080x1920
   frames (``bench.py``'s workload) with ``bench.py``'s configuration,
   counting each kernel's launches, and frames/s over the 24 steps after the
   priming frame; the warm-up steps run with synchronising CUDA operations
   turned into errors; the counted steps run with ``ops/farneback``'s
   functions that build the corner table (``pack_corner_pairs``,
   ``pack_corners``) stubbed to raise, so the card's K9 is shown to build none;
7. GMFA's ``preprocess`` at the reference load
   (``benchmarks/gmfa_reference_load.py``'s configuration, scene and keys: 7
   frames of ~56,000 raw points, RANSAC with 5000 hypotheses, 102,400
   expanded points): its first call with synchronising CUDA operations
   turned into errors, then the card's clouds equal to the CPU port's bit
   for bit on frames 0-2, with float32 and with q16 points;
8. K5 (the NN sweep) bit-equal to its serial plain version on frames 0 and
   1 of those clouds: uncapped, with the classification cap, an ICP-style
   active subset, every target twice (tied minima), and the inputs of ICP's
   busiest active round on that frame pair, with the compacting sweep and
   with the in-place one (per-block counts that are no prefix, filled rows, a
   block table shifted by the drift); at each cluster size (1, 2, 4,
   8, 16 CTAs per block) with its device µs and the busiest block's serial
   bound, and at the kept sizes; its bounds checked sound against a float64
   ``cKDTree`` on 4096 sampled rows; wrapper and plain version timed as in
   phase 3;
9. the GMFA step at a small configuration on the card against the CPU, on
   clouds the port preprocessed, with the same step keys (so the same new
   track ids);
10. GMFA's main path on the 7 clouds: ``seed_carry`` and 6 ``step`` calls,
    with K5's and K7's launches, the host synchronisations per step and the
    moving points against the 16,384 cap; then K5's device ms per step, full
    and active sweeps apart, at the kept sizes and at each cluster size (one
    step's sweeps recorded, then replayed under the profiler) and the sum
    of their bounds; then K7 (the once-rounded fma and sum of squares, of
    one operand or of a difference, ``ops/round_kernels``) bit-equal to its
    plain version on every input that one 1080x1920 stream step and one
    GMFA step give it (recorded through the wrappers, with each call site)
    and on infinities, NaNs, signed zeros and subnormals; the fma timed at
    its largest such input beside ``torch.addcmul``, the sum of squares at
    every recorded site beside ``F.pairwise_distance``, ``torch.cdist`` or
    ``torch.linalg.vecdot`` / ``vector_norm`` (each with its device µs and
    plain version; the kernels line takes tracker A's site);
11. the diagnostics that run K4 and K6, at full size, each with every launch
    count set to 0 just before it and read just after: ``micro_flow`` and
    ``profile_1080p`` on two ``make_frames`` 1080x1920 frames (K1-K4), and
    ``icp_body`` at 102,400 points (K6), whose K5 tile probe runs ICP on the
    preprocessed frame pair 0 -> 1 (K5);
12. pipeline A from PCD files at the reference's production shape
    (``benchmarks/from_points.py``: 12 frames of ~56,000 points, 5000 RANSAC
    hypotheses, a 200x200 BEV): the preprocess and step warm-up with
    synchronising CUDA operations turned into errors, the card's BEV equal
    to the CPU's on 3 frames, K1, K9 and K2 bit-equal at 200x200 and 60x60
    and timed, then ``process_files`` with float32 and with q16 points, each
    with the launch counts set to 0 just before and read just after (2 K1,
    10 K9 and 10 K2 launches per frame, no frame skipped, tracks out), and a
    4-frame run on the card against the CPU's;
13. GMFA from PCD files at a small configuration: ``process_files`` over 4
    ``synth`` frames on the card against the CPU (rows, track ids, states,
    SOM) and resumed on the card from a mid-run checkpoint (same rows);
14. the port's three benchmarks once each, shortened, each in its own
    process (``benchmarks/stream_1080p.py``, ``benchmarks/from_points.py``,
    ``benchmarks/gmfa_reference_load.py``);
15. the reference-API surface (``compat``, ``ops/nn``) on the card against
    the port on the CPU, each part with the launch counts set to 0 just
    before and read just after: ``compute_velocity_vectors`` on two 200x200
    from-points BEVs (K1 4, K3 10: compat warps exactly, so its small levels
    take K3 too) and on two 1080x1920 frames (K1 6, K3 15), as compat's
    Farnebäck defaults and the level sizes predict;
    the propagation and continuity masks, DBSCAN and the road filter on the
    200x200 flow (equal); ``process_multiple_frames`` over 4 from-points
    files with seeds 0 and 5 (tracks within the CPU tests' 5e-3);
    ``align_by_nearest`` on GMFA's preprocessed clouds (one K5 launch; 16,384
    rows of it equal to the CPU's); ``nearest_neighbors_scan`` at 300,000 targets
    and 4,096 queries against a float64 ``cKDTree`` within its envelope,
    timed (no plots: this machine has no matplotlib);
16. ICP's options: ``coarse_stride=4`` and ``sweep="inplace"`` on small
    clouds, each card call with the launch counts set to 0 just before and
    read just after (K5 once per round of each phase and once at the end,
    K7 launched), the card equal to the CPU field by field; at GMFA's
    reference load ``diagnostics/icp_sound``'s violation counts (all 0: K5's
    ``lo`` against a float64 scan, its sub-cap winners within K5's envelope
    and within 1e-6, one ~2 mm exclusion step) and one
    cached ICP per sweep, compact and in place, with its ms, K5's device ms,
    and the busiest round's K5 µs and busiest block (``icp_body --sweeps``,
    in a process of its own; K5 on that in-place round's inputs is phase
    8's last case);
17. the stream-parallel paths (``parallel/streams``): pipeline A's
    frame-pair step and stream-mode step over 4 feeds at 1080x1920 and
    GMFA's step over 4 feeds at reference load, each multi-stream step
    counted alone after the single-stream steps it is held to (every feed's
    outputs and carry equal, the metrics equal to the sums, the launches
    equal to the single-stream steps' sum); then
    ``benchmarks/multistream_4x1080p`` in a process of its own;
18. the multi-rank dry run (``python -m datmo_using_optical_flow_tpu_torch.
    dryrun --ranks 4 --backend gloo --device cuda``, in a process of its own
    with its own time limit): four ranks on this one card over gloo, the
    exchange through host memory, at the JAX dry run's sizes and
    tolerances: stream-parallel A at 200x200, the row-sharded flow at
    1088x1920 (272 rows per rank, EPE < 1e-3 against the unsharded flow),
    stream-parallel GMFA at 1024 points per feed, 2 feeds x 2 row ranks;
    the sharded level (64 rows per rank, 320 columns) on the card
    bit-equal to the CPU's over the same group after each of 3 iterations;
    every kernel of each phase held to its plain version on rank 0, on the
    inputs that phase gives it (the first call at each input signature: K1
    on the halo-extended 282x1920 block and the replicated 326x576 and
    98x173 levels, K3 at 326x576 and 98x173, K4 on the 272x1920 block (with
    its rows), K2 on the 286x1920 extended M, the 200x200
    pipelines' K1-K3 and K9, and K5 and K7 at 1024 points; K1-K4 and K9
    ``torch.equal`` and timed, K5 and K7 bit for bit); each rank's launches
    of one sharded flow call (counts set to 0 just before, read just after)
    equal to ``sharded_flow.sharded_flow_launches``; the sharded flow's ms
    per call on each rank beside the unsharded flow's (four ranks sharing
    one card: not a four-card speed);
19. pipeline A's stream step on the 4K grid (2176x3840, ``benchmarks/
    stream_4k``): K1-K3 ``torch.equal`` to their plain versions at every
    level (K1 at 2176x3840, 653x1152, 196x346, 59x104; K3 at the first
    three, K9 and K2 at 59x104) and timed (per call, device µs, bound, K1
    beside ``F.conv2d``); the step over 2 frames on the card, counted alone
    (K1 8, K3 30, K9 10, K2 10: each stream step runs the flow, the priming
    one against
    the zero pyramid), against the same 2 frames on the CPU (every output
    bit for bit but the track table's state, within 5e-3); then the
    benchmark shortened in its own process;
20. the batched flow at 720p (``benchmarks/flow_batched_720p``): K1-K3 at
    every level (720x1280, 216x384, 65x115) as in phase 19; the 8 pairs'
    batched flow counted alone (K1 48, K3 80, K9 40, K2 40), each pair equal to its
    own flow, pair 0 equal to the CPU's; the benchmark shortened in this
    process (1 repetition, 2 pairs within 0.1 px EPE of the numpy model of
    cv2);
21. the quality benchmark's evaluations (``benchmarks/quality``) on its
    easy scene over 12 frames, counted alone (K1, K3, K5, K7), pipeline A's
    velocity grids against the numpy model of cv2, its DBSCAN partitions
    reported as not run where sklearn does not import; then
    ``benchmarks/evaluate`` in its own process.

A flow kernel's device µs is reported as not measured where the profiler
keeps losing its trace's records late in this long process (a timing, not a
check; ``kernel_us``).  The second-to-last line is a JSON summary of the
kernels, each with its bound on the H100 for the timed call's work
(``diagnostics/roofline.py``);
the line before it is ``nvidia-smi``'s name and power limit of the card; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import signal
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
    # K7: no Pallas kernel; XLA fuses these multiply-adds at sites such as
    "fma32": "datmo_using_optical_flow_tpu/models/optical_flow_datmo.py:601",
    "sumsq": "datmo_using_optical_flow_tpu/models/tracker_a.py:169",
    # and ICP's fused dot + add of the transform (its plain version's four calls)
    "transform_points": "datmo_using_optical_flow_tpu/ops/icp.py:101,117,375",
    # K8: no Pallas kernel either; XLA fuses the level image's blur and resize
    "level_image": "none: XLA's fused gaussian_blur/resize_bilinear, "
                   "datmo_using_optical_flow_tpu/ops/farneback.py:68,76",
    # K9: neither; XLA runs the small levels' packed warp (the kernel path's too)
    "warp_packed": "none: XLA's fused update_matrices with R1_packed, "
                   "datmo_using_optical_flow_tpu/ops/farneback.py:256",
    # K9's scale pass: the planes' scales of pack_corner_pairs, which XLA fuses
    "corner_scale": "none: K9's scale pass, XLA's fused pack_corner_pairs scales, "
                    "datmo_using_optical_flow_tpu/ops/farneback.py:180",
}
SOURCES = {"poly_exp": "flow_kernels.cu", "blur_solve": "flow_kernels.cu",
           "fused_iteration": "flow_kernels.cu", "warp_matrices": "flow_kernels.cu",
           "nearest_neighbors": "nn_kernels.cu", "tiny": "probe_kernels.cu",
           "fma32": "round_kernels.cu", "sumsq": "round_kernels.cu",
           "transform_points": "round_kernels.cu",
           "level_image": "level_kernels.cu", "warp_packed": "flow_kernels.cu",
           "corner_scale": "flow_kernels.cu"}
# 1080p, 3 levels; K8: one launch for the frame's level images, one per
# upsample; K9 and K2 five each on the 97x173 level, after K9's scale pass
PER_STEP = {"poly_exp": 3, "fused_iteration": 10, "blur_solve": 5, "level_image": 3,
            "warp_packed": 5, "corner_scale": 1}
# K7's launches follow the data (tracker A's association runs once per
# cluster slot), so the exact per-path counts below are of K1-K6 and K8
ROUNDING = ("fma32", "sumsq", "transform_points")
# the K7 forms each pipeline's step launches: A's magnitude and distances;
# GMFA's ICP transforms (no fma32 since the one-launch transform) and distances
A_ROUNDING = ("fma32", "sumsq")
GMFA_ROUNDING = ("sumsq", "transform_points")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def _counted_modules():
    from datmo_using_optical_flow_tpu_torch.ops import (flow_kernels, level_kernels, nn_kernels,
                                                        probe_kernels, round_kernels)

    return flow_kernels, level_kernels, nn_kernels, probe_kernels, round_kernels


def reset_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


def tpu_kernels(counts: dict) -> dict:
    """The counts of K1-K6 and K8, the kernels with a count fixed by the shapes."""
    return {k: v for k, v in counts.items() if k not in ROUNDING}


def need_rounding(label: str, counts: dict, kernels: tuple = A_ROUNDING) -> None:
    """Raise unless each of the K7 ``kernels`` launched in a counted run."""
    if any(counts[k] <= 0 for k in kernels):
        raise AssertionError(f"{label}: K7 {[counts[k] for k in kernels]} launches of "
                             f"{kernels}; each runs on this path")


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


def check(kernel: str, label: str, got, want, bits: bool = False) -> float:
    """Raise unless ``got`` equals ``want`` bit for bit (``torch.equal``: K1-K4,
    K8 and K9 all are; with ``bits`` also as int32, so a zero's sign counts:
    one tensor).  Logs and returns the max abs error."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    err = max_abs(got, want)
    log(f"{kernel} {label}: max_abs_err {err:.3e} (bit-equal required"
        f"{', int32 bits' if bits else ''})")
    if not equal(got, want) or (bits and not round_kernels.bits_equal(got, want)):
        raise AssertionError(f"{kernel} {label}: error {err} (bit-equal required)")
    return err


def smooth_flow(h: int, w: int, dev, amp: float = 4.0):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    dx = amp * torch.sin(yy / 23) * torch.cos(xx / 31)
    dy = 0.7 * amp * torch.cos(yy / 19) * torch.sin(xx / 37)
    return dx.contiguous(), dy.contiguous()


def kernel_us(fn, dev, label: str, reps: int = 5) -> float | None:
    """Device µs per call of a kernel (``measure.device_us_per_call``), or
    None, logged as not measured, when the profiler keeps losing the trace's
    kernel records: late in this long process the card's traces at times come
    back empty.  A timing, not a check (``dryrun._kernel_row`` and the stage
    rows treat it the same way); the ms per call stands."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    try:
        return measure.device_us_per_call(fn, dev, reps)
    except measure.LostTrace as e:
        log(f"{label}: device time not measured ({e})")
        return None


def share(bound: float, us: float | None) -> str:
    """``bound / us`` formatted, or "not measured"."""
    return "not measured" if us is None else f"{bound / us:.3f}"


def us_text(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.1f} us"


def kernel_phases(dev, name: str, smi: str, h: int, w: int) -> dict:
    """Each kernel against its plain version at the main path's shapes, timed."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
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
               timed: bool, bits: bool = False) -> None:
        err = check(kernel, label, got, want, bits)
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
        us = kernel_us(lambda: fk.poly_exp(img, 5, 5.0), dev, f"poly_exp {label}")
        lib_ms = library_phase("poly_exp", label, poly_exp_conv(img, 5, 5.0), want,
                               1e-3 * float(want.abs().max()), dev, name, smi)
        bound = roofline.poly_exp(lh, lw).bound_us()
        k1_levels[label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us,
                            "library_ms": lib_ms, "bound_us": bound}
        log(f"poly_exp {label}: device {us_text(us)} per call, bound {bound:.3f} us, share "
            f"{share(bound, us)} [{name}, {smi}]")
        if level == top:
            results["poly_exp"]["library_ms"] = lib_ms

    R0, R1 = pyr[0][0], pyr[1][0]  # the coarsest level
    zero = torch.zeros(R0.shape[1:], dtype=torch.float32, device=dev)
    label = f"{R0.shape[1]}x{R0.shape[2]}"
    scale = fk.corner_scale(R1)
    results["corner_scale"] = k9_scale_row(dev, name, smi, R1, label)
    M = fk.warp_matrices_packed(R0, R1, scale, zero, zero)
    ms, plain_ms = time_pair(lambda: fk.warp_packed_reference(R0, R1, scale, zero, zero),
                             lambda: fk.warp_matrices_packed(R0, R1, scale, zero, zero))
    record("warp_packed", f"{label} zero flow", M,
           fk.warp_packed_reference(R0, R1, scale, zero, zero), ms, plain_ms, timed=True,
           bits=True)
    for gaussian in (False, True):
        got, want = fk.blur_solve(M, 15, gaussian), fk.blur_solve_reference(M, 15, gaussian)
        ms, plain_ms = time_pair(lambda: fk.blur_solve_reference(M, 15, gaussian),
                                 lambda: fk.blur_solve(M, 15, gaussian))
        record("blur_solve", f"{label} {'gauss' if gaussian else 'box'}",
               got, want, ms, plain_ms, timed=not gaussian)
        # between iterations: the numerators and 1 / det, and K9 on that flow
        nx, ny, idet = fk.blur_solve(M, 15, gaussian, terms=True)
        check("blur_solve", f"{label} {'gauss' if gaussian else 'box'} (nx, ny, 1/det)",
              (nx, ny, idet), fk.blur_solve_reference(M, 15, gaussian, terms=True))
        check("warp_packed", f"{label} flow (nx, ny) * 1/det",
              fk.warp_matrices_packed(R0, R1, scale, nx, ny, idet),
              fk.warp_packed_reference(R0, R1, scale, nx, ny, idet), bits=True)
    k9_edge_cases(dev, full)

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
        # the flow as the main path carries it: upsampled times 1 / pyr_scale
        # into the first iteration, (nx, ny) times 1 / det between iterations
        inv = float(np.float32(1 / 0.3))
        nx, ny, idet = fk.fused_iteration(R0, R1, dx, dy, 15, False, inv, True)
        check("fused_iteration", f"{label} flow (dx, dy) * 1/0.3, (nx, ny, 1/det) out",
              (nx, ny, idet), fk.fused_iteration_reference(R0, R1, dx, dy, 15, False, inv, True))
        for gaussian in (False, True):
            check("fused_iteration", f"{label} flow (nx, ny) * 1/det, gauss={gaussian}",
                  fk.fused_iteration(R0, R1, nx, ny, 15, gaussian, idet),
                  fk.fused_iteration_reference(R0, R1, nx, ny, 15, gaussian, idet))
        if i < 2:  # the two levels that run K3 on the main path
            us = kernel_us(lambda: fk.fused_iteration(R0, R1, dx, dy, 15), dev,
                           f"fused_iteration {label}")
            levels[label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us}
            log(f"fused_iteration {label}: device {us_text(us)} per call [{name}, {smi}]")

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

    for scale in (None, float(np.float32(1 / 0.3))):  # the flow, or the upsampled flow
        got = fk.blur_solve(fk.warp_matrices(R0, R1, dx, dy, scale), win, gaussian)
        want = fk.fused_iteration(R0, R1, dx, dy, win, gaussian, scale)
        err = max_abs(got, want)
        log(f"warp_matrices into blur_solve vs fused_iteration {label} win={win} "
            f"gauss={gaussian} flow scale {scale}: max_abs_err {err:.3e} (bit-equal required)")
        if not equal(got, want):
            raise AssertionError(f"K4 into K2 {label}: differs from K3 (max_abs_err {err})")


def poly_exp_conv(img, n: int, sigma: float):
    """One ``F.conv2d`` that computes K1's function, timed beside K1
    (``diagnostics/micro_flow.conv_yardstick``); the port does not use it."""
    from datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow import conv_yardstick

    return conv_yardstick(img, n, sigma)


def scale_library(R1):
    """K9's scale pass's yardstick, ``torch.amax(R1.abs(), (1, 2))`` (the
    planes' maxima, before the clamp and the reciprocal), and those maxima
    by the plain version's ops."""
    return (lambda: torch.amax(R1.abs(), (1, 2))), torch.amax(torch.abs(R1), dim=(1, 2))


def k9_scale_row(dev, name: str, smi: str, R1, label: str) -> dict:
    """K9's scale pass at ``R1`` bit-equal to its plain version, timed beside
    it (per call) and beside its yardstick, with its device µs."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    err = check("corner_scale", label, fk.corner_scale(R1), fk.corner_scale_reference(R1),
                bits=True)
    ms, plain_ms = time_pair(lambda: fk.corner_scale_reference(R1), lambda: fk.corner_scale(R1))
    lib_ms = library_phase("corner_scale", label, *scale_library(R1), 0.0, dev, name, smi)
    us = kernel_us(lambda: fk.corner_scale(R1), dev, f"corner_scale {label}")
    bound = roofline.corner_scale(*R1.shape[1:]).bound_us()
    log(f"corner_scale {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.amax "
        f"{lib_ms:.4f} ms, device {us_text(us)}, bound {bound:.3f} us, share "
        f"{share(bound, us)} [{name}, {smi}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_us": us, "levels": {}}


def k9_edge_cases(dev, image) -> None:
    """K9's scale pass and warp bit-equal (int32) to their plain versions at
    the CPU tests' edge shapes: 5x122 (the scalar remainder of the ``vec``
    rule), 1x173 and 97x1 (no pixel inside), each at zero, 1.5 px, 6 px and
    the carried (nx, ny, 1/det) flow; an all-zero R1 plane (the 1e-20
    clamp); corners in (-scale / 2, 0) over R0 of -0.0 (the zero signs the
    table's integers give); and 1080x1920, K1's planes of ``image``."""
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    gen = torch.Generator(device=dev).manual_seed(22)

    def planes(h, w):
        return fk.poly_exp(torch.rand((h, w), device=dev, generator=gen) * 255, 5, 5.0)

    def hold(label, R0, R1, flows):
        scale = fk.corner_scale(R1)
        check("corner_scale", label, scale, fk.corner_scale_reference(R1), bits=True)
        for flow_label, dx, dy, s in flows:
            check("warp_packed", f"{label} {flow_label}",
                  fk.warp_matrices_packed(R0, R1, scale, dx, dy, s),
                  fk.warp_packed_reference(R0, R1, scale, dx, dy, s), bits=True)

    for h, w in ((5, 122), (1, 173), (97, 1), (60, 60)):
        R0, R1 = planes(h, w), planes(h, w)
        flows = [("zero flow", *[torch.zeros((h, w), device=dev)] * 2, None)]
        for amp in (1.5, 6.0):
            flows.append((f"{amp} px flow",
                          *(torch.randn((h, w), device=dev, generator=gen) * amp
                            for _ in range(2)), None))
        M = fk.warp_matrices_packed(R0, R1, fk.corner_scale(R1), *flows[0][1:3])
        flows.append(("carried flow (nx, ny) * 1/det", *fk.blur_solve(M, 15, False, True)))
        if (h, w) == (60, 60):  # an all-zero plane of R1
            R1[3] = 0.0
            label = "60x60 with an all-zero R1 plane"
        else:
            label = f"{h}x{w}"
        hold(label, R0, R1, flows)
    h, w = 12, 40  # every corner in (-scale / 2, 0) but the one that sets the scale
    R0 = torch.full((5, h, w), -0.0, device=dev)
    R1 = -torch.rand((5, h, w), device=dev, generator=gen) * 0.45
    R1[:, h - 1, w - 1] = torch.tensor([32767.0, 32767.0, 127.0, 127.0, 127.0], device=dev)
    zero = torch.zeros((h, w), device=dev)
    hold(f"{h}x{w} corners in (-scale/2, 0)", R0, R1, [("zero flow", zero, zero, None)])
    R0, R1 = (fk.poly_exp(image + k, 5, 5.0) for k in (0.0, 1.0))
    dx, dy = smooth_flow(*image.shape, dev)
    hold(f"{image.shape[0]}x{image.shape[1]}", R0, R1, [("smooth flow", dx, dy, None)])


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


# ------------------------------------------------------------------ K8: level images and upsamples

def _k8_paths():
    """The flows whose level images and upsamples K8 runs: (path, (h, w),
    Farnebäck settings)."""
    from datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow import k8_paths

    return k8_paths()


def _no_tf32(fn):
    """``fn`` with cuDNN's TF32 off for the call."""
    def call():
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    return call


def level_image_conv(img, ksize: int, sigma: float, lh: int, lw: int):
    """One PyTorch composition that computes K8's level image: the
    reflect-padded image through a separable ``F.conv2d`` (cuDNN's TF32 off),
    then ``F.interpolate`` (bilinear, ``align_corners=False``) unless the
    level is full size.  Timed beside K8; the port does not use it."""
    import torch.nn.functional as F

    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb

    taps = torch.as_tensor(fb.blur_taps(ksize, sigma), device=img.device)
    n = len(taps) // 2

    def call():
        x = F.pad(img[None, None], (n, n, n, n), mode="reflect")
        x = F.conv2d(F.conv2d(x, taps.view(1, 1, -1, 1)), taps.view(1, 1, 1, -1))
        if tuple(x.shape[-2:]) != (lh, lw):
            x = F.interpolate(x, size=(lh, lw), mode="bilinear", align_corners=False)
        return x[0, 0]

    return _no_tf32(call)


def pyramid_conv(img, sizes):
    """The sum of :func:`level_image_conv` over a frame's levels: one PyTorch
    composition per level image, the yardstick of K8's one launch."""
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb

    calls = [level_image_conv(img, *fb.level_blur(scale), lh, lw) for scale, lh, lw in sizes]
    return lambda: tuple(call() for call in calls)


def level_image_phase(dev, name: str, smi: str) -> dict:
    """K8 ``torch.equal`` to its plain version at each path's (1080p, from
    points, 4K, 720p) level images in one launch, at every level image alone
    (level 0, the blur alone, included) and at the upsample of each level
    transition in the main path's form (two planes, scale 1.0), each timed:
    per call (CUDA events, in turns with the plain version), device µs,
    bound (``diagnostics/roofline``) and the library call (:func:`pyramid_conv`,
    :func:`level_image_conv`; ``F.interpolate`` of the stacked flow), held to
    1e-3 of the level's scale; the general form (the resize of a stack times
    1 / pyr_scale) ``torch.equal`` too.  Then the upsample's host launch path
    in parts (``micro_flow.upsample_path``).  The 1080p pyramid is the
    kernels line's timed call."""
    import torch.nn.functional as F

    from datmo_using_optical_flow_tpu_torch.diagnostics import micro_flow, roofline
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels as lk
    from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = {}

    def row(label, kern, plain, work, lib):
        want = plain()
        err = check("level_image", label, kern(), want)
        ms, plain_ms = time_pair(plain, kern)
        us = kernel_us(kern, dev, f"level_image {label}")
        scale = max(float(x.abs().max()) for x in (want if isinstance(want, tuple) else (want,)))
        lib_ms = library_phase("level_image", label, lib, want, 1e-3 * scale, dev, name, smi)
        bound = work.bound_us()
        rows[label] = {"ms": ms, "plain_ms": plain_ms, "device_us": us, "library_ms": lib_ms,
                       "bound_us": bound, "max_abs_err": err}
        log(f"level_image {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device "
            f"{us_text(us)}, bound {bound:.3f} us ({work.bound_by()}), share "
            f"{share(bound, us)}, library {lib_ms:.4f} ms [{name}, {smi}]")

    for tag, (h, w), c in _k8_paths():
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        sizes = [(s, lh, lw) for _, s, lh, lw in level_sizes(h, w, c.pyr_scale, c.levels)]
        taps = [len(lk._taps(*fb.level_blur(s))[1]) for s, _, _ in sizes]
        row(f"{h}x{w} level images, {len(sizes)} levels in one launch ({tag})",
            lambda sizes=sizes: fb.level_images(img, sizes),
            lambda sizes=sizes: fb.level_images_reference(img, sizes),
            roofline.level_images(h, w, [(lh, lw, n) for (_, lh, lw), n in zip(sizes, taps)]),
            pyramid_conv(img, sizes))
        for (scale, lh, lw), n in zip(sizes, taps):
            ksize, sigma = fb.level_blur(scale)
            row(f"{h}x{w} -> {lh}x{lw}, {ksize} taps ({tag})",
                lambda scale=scale, lh=lh, lw=lw: fb.level_image(img, scale, lh, lw),
                lambda scale=scale, lh=lh, lw=lw: fb.level_image_reference(img, scale, lh, lw),
                roofline.level_image(h, w, lh, lw, n),
                level_image_conv(img, ksize, sigma, lh, lw))
        inv = float(np.float32(1.0 / c.pyr_scale))
        for (_, ph, pw), (_, lh, lw) in zip(sizes, sizes[1:]):
            dx, dy = (torch.randn((ph, pw), device=dev, generator=gen).mul_(3.0)
                      for _ in range(2))
            stacked = torch.stack([dx, dy])
            row(f"upsample 2x{ph}x{pw} -> {lh}x{lw} ({tag})",
                lambda dx=dx, dy=dy, lh=lh, lw=lw: fb.upsample(dx, dy, lh, lw),
                lambda st=stacked, lh=lh, lw=lw: tuple(
                    fb.resize_bilinear_reference(st, lh, lw)),
                roofline.resize(2, ph, pw, lh, lw, False),
                lambda st=stacked, lh=lh, lw=lw: tuple(F.interpolate(
                    st[None], size=(lh, lw), mode="bilinear", align_corners=False)[0]))
            check("level_image", f"resize 2x{ph}x{pw} -> {lh}x{lw} times 1/{c.pyr_scale} "
                  f"(general form, {tag})", fb.resize_bilinear(stacked, lh, lw, inv),
                  fb.resize_bilinear_reference(stacked, lh, lw, inv))
    top = rows["1080x1920 level images, 3 levels in one launch (1080p)"]
    path = micro_flow.upsample_path(dev, f"{name}, {smi}")
    log(f"phase 3b (K8, {len(rows)} shapes bit-equal): {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(r["max_abs_err"] for r in rows.values()), "ms": top["ms"],
            "plain_ms": top["plain_ms"], "library_ms": top["library_ms"], "levels": rows,
            "upsample_launch_path_us": path["package"]}


def launch_path_breakdown(x, name: str, smi: str, n: int = 1000) -> dict:
    """Host µs per call of each part of K6's launch path (``kernels/build.Entry``),
    each over ``n`` calls in a Python loop on the host clock, beside the whole
    wrapper call and ``torch.add``: the wrapper's checks of its input, the
    output's allocation, the raw stream lookup, the ctypes call that launches
    the kernel (with its device guard in C), and the check of its return."""
    from datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow import host_us
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
    us = host_us(parts, x.device, n)
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
    tiny_window_phase(dev)
    k8_edge_phase(dev)


# ROADMAP Queue 3 item 10's shapes: one row, one column, 1x1, a radius past
# the axis; (h, w, ksize, sigma) of the blur
K8_EDGES = ((1, 64, 3, 0.0), (64, 1, 3, 0.0), (1, 1, 3, 0.0), (3, 200, 25, 5.0556),
            (64, 1, 7, 1.1667), (1, 300, 91, 18.019), (300, 1, 25, 5.0556))


def k8_edge_phase(dev) -> None:
    """K8 at :data:`K8_EDGES`, ``torch.equal`` to its plain versions: the
    blur, and the image with its levels at 0.3 and 0.09 in one launch."""
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels as lk

    gen = torch.Generator(device=dev).manual_seed(10)
    for h, w, ksize, sigma in K8_EDGES:
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        check("level_image", f"{h}x{w} blur, {ksize} taps (edge shape)",
              lk.blur(img, ksize, sigma), fb.gaussian_blur_reference(img, ksize, sigma))
        sizes = [(1.0, h, w)] + [(s, max(1, round(h * s)), max(1, round(w * s)))
                                 for s in (0.3, 0.09)]
        reset_launches()
        got = fb.level_images(img, sizes)
        if read_launches()["level_image"] != 1:
            raise AssertionError(f"K8 {h}x{w}: {read_launches()['level_image']} launches, "
                                 f"one expected")
        check("level_image", f"{h}x{w} levels {[s[1:] for s in sizes]} in one launch "
              f"(edge shape)", got, fb.level_images_reference(img, sizes))
    log(f"K8 at {len(K8_EDGES)} edge shapes: bit-equal, one launch a frame")


# levels of an axis at most 4 (K4's one-valued attenuation) and of an axis at
# most the radius of the Gaussian window (K2's broadcast taps), and thin ones
TINY_LEVELS = ((2, 2), (3, 3), (4, 4), (2, 4), (4, 2), (3, 4), (4, 3), (1, 4), (4, 1), (2, 64),
               (64, 2), (3, 40), (40, 3), (4, 40), (40, 4), (60, 6), (7, 7))


def tiny_window_phase(dev) -> None:
    """K4 and K2 at tiny levels, ``torch.equal`` to their plain versions:
    K4's instance for a level whose attenuation is one value (at most 4 rows
    and columns) with the flow as it enters a warp (given, times 1 /
    pyr_scale, or the last solve's numerators times 1 / det), and K2's
    Gaussian window where an axis is at most its radius (the runtime-radius
    stage with the broadcast taps), at winsizes 15 and 5."""
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    gen = torch.Generator(device=dev).manual_seed(19)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    n = 0
    for h, w in TINY_LEVELS:
        R0, R1 = rand(5, h, w), rand(5, h, w)
        dx, dy = rand(h, w) * 1.5, rand(h, w) * 1.5
        for scale in (None, float(np.float32(1 / 0.3)), rand(h, w).abs() + 0.5):
            check("warp_matrices", f"{h}x{w} tiny level (flow scale "
                  f"{'none' if scale is None else type(scale).__name__})",
                  fk.warp_matrices(R0, R1, dx, dy, scale),
                  fk.warp_matrices_reference(R0, R1, dx, dy, scale))
            n += 1
        M = rand(5, h, w) ** 2
        for win in (15, 5):
            for terms in (False, True):
                check("blur_solve", f"{h}x{w} tiny level win={win} gauss terms={terms}",
                      fk.blur_solve(M, win, True, terms),
                      fk.blur_solve_reference(M, win, True, terms))
                n += 1
    log(f"K4 and K2 (Gaussian) at {len(TINY_LEVELS)} tiny levels: {n} calls bit-equal")


# The small levels of the exact warp that K3 runs (ops/warp.exact_fused):
# compat's and the quality run's 60x60 and 200x200, the 1080p flow's 97x173,
# the sharded flow's replicated 98x173
ROUTED_LEVELS = ((60, 60), (97, 173), (98, 173), (200, 200))
# the route's edges: lines, K4's one-valued attenuation (at most 4x4), the
# Gaussian window's broadcast taps (an axis within its radius), and past them
ROUTE_EDGES = ((1, 64), (64, 1), (2, 2), (4, 4), (2, 4), (4, 5), (5, 4), (2, 64), (64, 2),
               (3, 40), (40, 3), (7, 7), (8, 8))
# kernels/build.check's words for the code a C entry returns when it refuses
# its arguments (cudaErrorInvalidValue)
REFUSAL = "CUDA error 1: invalid argument"


def exact_route_phase(dev, name: str, smi: str) -> tuple[dict, dict]:
    """Phase 4c: the route of the small exact-warp levels through K3.  At
    each of :data:`ROUTED_LEVELS`, box and Gaussian window, with zero flow,
    a given flow and that flow times 1 / pyr_scale (flow modes 0 and 1, then
    2 between iterations): each of 5 iterations of K3 ``torch.equal`` to its
    plain version on the same inputs, then the whole level
    (``farneback_level(..., fast_warp=False)``), counted alone (5 K3
    launches, no K4 or K2), ``torch.equal`` to the plain level; the box
    level with zero flow timed (per call, device µs, bound).  At
    :data:`ROUTE_EDGES`, both windows, ``ops/warp.exact_fused`` held to the C
    entry case by case: where it holds K3 launches and equals its plain
    version, elsewhere ``datmo_fused_iteration`` refuses the level, and the
    level (3 iterations) runs K4 then K2, equal to its plain version.
    Returns K3's timed rows and the phase's launches."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow import level_run
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
    from datmo_using_optical_flow_tpu_torch.ops import warp

    def plain_level(R0, R1, dx, dy, gaussian, s, iterations):
        """K3's plain version (K4's then K2's) each iteration, the flow carried."""
        return level_run(fk.fused_iteration_reference, R0, R1, dx, dy, s, 15, gaussian,
                         iterations)()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    inv = float(np.float32(1 / 0.3))
    rows, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for h, w in ROUTED_LEVELS:
        R0, R1 = (fk.poly_exp(torch.rand((h, w), device=dev, generator=gen) * 255, 5, 5.0)
                  for _ in range(2))
        zero = torch.zeros((h, w), dtype=torch.float32, device=dev)
        sdx, sdy = smooth_flow(h, w, dev, amp=1.5)
        for gaussian in (False, True):
            if not warp.exact_fused(h, w, 15, gaussian):
                raise AssertionError(f"route {h}x{w}: exact_fused refuses a routed level")
            for flow, (dx, dy, s) in (("zero flow", (zero, zero, None)),
                                      ("given flow", (sdx, sdy, None)),
                                      ("flow times 1/pyr_scale", (sdx, sdy, inv))):
                label = f"{h}x{w} {'Gaussian' if gaussian else 'box'}, {flow}"
                vx, vy, vs = dx, dy, s
                for i in range(5):
                    terms = i < 4
                    got = fk.fused_iteration(R0, R1, vx, vy, 15, gaussian, vs, terms)
                    want = fk.fused_iteration_reference(R0, R1, vx, vy, 15, gaussian, vs, terms)
                    if not equal(got, want):
                        raise AssertionError(f"route {label}, iteration {i + 1}: K3 differs "
                                             f"from its plain version by {max_abs(got, want)}")
                    if terms:
                        vx, vy, vs = got

                def level(dx=dx, dy=dy, s=s, g=gaussian):
                    return fb.farneback_level(R0, R1, dx, dy, 15, 5, False, g, s)

                got, counts = _counted(f"route {label}", level, {"fused_iteration": 5})
                add(counts)
                plain = plain_level(R0, R1, dx, dy, gaussian, s, 5)
                err = check("fused_iteration", f"route {label}: each of 5 iterations and the "
                            f"level", got, plain)
                if gaussian or s is not None or dx is not zero:
                    continue
                ms, plain_ms = time_pair(
                    lambda: plain_level(R0, R1, zero, zero, False, None, 5), level, 5, 1)
                us = kernel_us(level, dev, f"route {label}")
                bound = sum(roofline.fused_iteration(h, w, 15, 2 if i == 0 else 3,
                                                     3 if i < 4 else 2).bound_us()
                            for i in range(5))
                rows[f"{h}x{w} small exact level, 5 iterations (route)"] = {
                    "ms": ms, "plain_ms": plain_ms, "device_us": us, "library_ms": None,
                    "bound_us": bound, "max_abs_err": err}
                log(f"route {label}, 5 iterations: {ms:.4f} ms per level, device "
                    f"{us_text(us)} (bound {bound:.3f} us, share {share(bound, us)}), plain "
                    f"{plain_ms:.4f} ms [{name}, {smi}]")
    n = 0
    for h, w in ROUTE_EDGES:
        R0, R1 = (torch.randn((5, h, w), device=dev, generator=gen) for _ in range(2))
        dx, dy = (torch.randn((h, w), device=dev, generator=gen) * 1.5 for _ in range(2))
        for gaussian in (False, True):
            fused = warp.exact_fused(h, w, 15, gaussian)
            label = f"{h}x{w} {'Gaussian' if gaussian else 'box'}"
            try:
                got = fk.fused_iteration(R0, R1, dx, dy, 15, gaussian)
            except RuntimeError as e:
                # the entry's refusal is cudaErrorInvalidValue, as build.check
                # words it; any other failure is a fault of the kernel
                if REFUSAL not in str(e):
                    raise
                got = None
            if fused != (got is not None):
                raise AssertionError(f"route edge {label}: exact_fused says {fused}, the C entry "
                                     f"{'took' if got is not None else 'refused'} the level")
            if fused:
                check("fused_iteration", f"route edge {label}", got,
                      fk.fused_iteration_reference(R0, R1, dx, dy, 15, gaussian))
            want = ({"fused_iteration": 3} if fused else {"warp_matrices": 3, "blur_solve": 3})
            got, counts = _counted(f"route edge {label} level", lambda g=gaussian: fb.
                                   farneback_level(R0, R1, dx, dy, 15, 3, False, g), want)
            add(counts)
            check("fused_iteration" if fused else "blur_solve", f"route edge {label} level "
                  f"({'K3' if fused else 'K4 then K2'})", got,
                  plain_level(R0, R1, dx, dy, gaussian, None, 3))
            n += 1
    log(f"phase 4c (the exact route, {len(ROUTED_LEVELS)} levels x 2 windows x 3 flows, "
        f"{n} edge cases): {time.perf_counter() - t0:.1f} s")
    return rows, launches


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

    from unittest import mock

    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb

    def no_table(*_):
        raise AssertionError("the card's main path built K9's corner table")

    reset_launches()
    # the benchmark's sweep: prime, then steps; K9 quantises from R1 on the
    # card, so neither function that builds the plain corner table may run
    with mock.patch.object(fb, "pack_corner_pairs", no_table), \
            mock.patch.object(fb, "pack_corners", no_table):
        elapsed, carry, out = timed_sweep(pipe, bevs)
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
    need_rounding(f"{h}x{w} main path", launches)
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
    round gave K5 on this frame pair (recorded around its active query),
    with the compacting sweep and with the in-place one."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import icp_body
    from datmo_using_optical_flow_tpu_torch.ops import nn as icp_nn
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
    # the in-place sweep's busiest round: per-block counts that are no
    # prefix, inactive rows of mixed blocks filled with the block's first
    # active row, and the ICP's one block table shifted by the round's drift
    _, irounds, ibusiest = icp_body.record_icp_rounds(
        prev, prev_m, cur, cur_m, icp_cfg.threshold, icp_cfg.max_iterations, sweep="inplace")
    ipts, iactive, _, icap2, itable, idrift = irounds[ibusiest]
    isrc, icounts = icp_nn.inplace_inputs(ipts, iactive)
    i_live = int((icounts > 0).sum())
    i_mixed = int(((icounts > 0) & (icounts < k5.SRC_BLOCK)).sum())
    return [("uncapped", src, index, {}, src_valid, cur, cur_m),
            ("capped (2*0.6)^2", src, index, {"cap2": cls_cap2}, src_valid, cur, cur_m),
            (f"active {n_act}/{src.shape[0]} cap (5*0.02)^2", src_c, index,
             {"n_active": n_act, "cap2": icp_cap2, "block_table": k5.build_block_table(src_c, index)},
             torch.arange(src.shape[0], device=dev) < n_act, cur, cur_m),
            ("every target twice (tied minima)", src, k5.build_target_index(dup, dup_m), {},
             src_valid, dup, dup_m),
            (f"ICP round {busiest} ({r_act} active rows)", rp.src, rp.index,
             {"n_active": r_act, "cap2": float(rp.cap2[0])},
             torch.arange(rp.src.shape[0], device=dev) < r_act, cur, cur_m),
            (f"in-place ICP round {ibusiest} ({int(iactive.sum())} active rows in {i_live} "
             f"blocks, {i_mixed} mixed, drift {float(idrift):.3e} m)", isrc, index,
             {"cap2": icap2, "block_counts": icounts, "block_table": itable, "drift": idrift},
             iactive, cur, cur_m)]


def nn_phase(dev, name: str, smi: str, cases) -> dict:
    """K5 against its serial plain version (bit-equal) on ``cases``, at each
    cluster size and at the source's, with its bounds checked sound; device
    µs per cluster size; per-call ms of the wrapper and the plain version,
    timed as in phase 3; the tiles each block visits (read from the plain
    sweep) and the bounds they set."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as k5

    res = {"max_abs_err": 0.0, "cases": []}
    for i, (label, s, index, kw, rows, tgt, tgt_m) in enumerate(cases):
        p = k5.prepare(s, index, **kw)
        active = "n_active" in kw or "block_counts" in kw  # as the wrapper chooses
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
            per_c[c] = kernel_us(lambda: k5._sweep_kernel(p, c), dev, f"K5 {label} C={c}",
                                 reps=3)
            log(f"K5 {label} C={c}: bit-equal, device {us_text(per_c[c])}, busiest block's serial "
                f"bound {roofline.nearest_neighbors_serial_us(vmax, c):.3f} us "
                f"[{name}, {smi}]")
        kept_us = kernel_us(lambda: k5._sweep_kernel(p, active=active), dev, f"K5 {label}",
                            reps=3)
        row = {"label": label, "device_us": per_c, "kept_us": kept_us,
               "bound_us": work.bound_us(), "visits_max": vmax}
        if i != 3:  # the tie case is a check, not a shape of the path
            ms, plain_ms = time_pair(lambda: k5.nearest_neighbors_reference(s, index, **kw),
                                     lambda: k5.nearest_neighbors(s, index, **kw),
                                     rounds=3, warmup=1)
            row.update(ms=ms, plain_ms=plain_ms)
            log(f"K5 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (incl. the "
                f"block table), kernel device {us_text(kept_us)} [{name}, {smi}]")
        res["cases"].append(row)
        if i == 0:
            res["ms"], res["plain_ms"], res["work"] = row["ms"], row["plain_ms"], work
    return res


def k5_step_phase(dev, name: str, smi: str, pipe, clouds) -> dict:
    """K5's device ms per GMFA step, full and active sweeps apart, at the
    source's cluster size and at each size: the step on frame 1 after
    ``seed_carry`` on frame 0, with every K5 call's inputs recorded, then the
    recorded sweeps replayed under the profiler; and the sum of the step's
    launches' bounds (``icp_body.sweeps_bound_us``)."""
    from unittest import mock

    from datmo_using_optical_flow_tpu_torch.diagnostics import icp_body
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
            us = kernel_us(lambda: [k5._sweep_kernel(p, cluster, g == "active") for p in ps],
                           dev, f"K5 per GMFA step, {g} sweeps, cluster {cluster}", reps=1)
            out[g] = None if us is None else us / 1e3
        out["total"] = None if None in out.values() else out["full"] + out["active"]
        return out

    def ms_text(v):
        return "not measured" if v is None else f"{v:.3f}"

    res = {"kept": step_ms(None)}
    for c in k5.CLUSTER_SIZES:
        res[c] = step_ms(c)
    for key, ms in res.items():
        log(f"K5 per GMFA step ({len(groups['full'])} full + {len(groups['active'])} active "
            f"sweeps), {'kept cluster size' if key == 'kept' else f'C={key}'}: device "
            f"{ms_text(ms['total'])} ms (full {ms_text(ms['full'])}, active "
            f"{ms_text(ms['active'])}) [{name}, {smi}]")
    res["bound_us"] = icp_body.sweeps_bound_us(calls)
    log(f"K5 per GMFA step: the sum of its {len(calls)} launches' bounds "
        f"{res['bound_us']:.1f} us (roofline, the tiles each live block visits)")
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

    torch.cuda.synchronize()
    reset_launches()
    carry = pipe.seed_carry(*clouds[0])
    t0 = time.perf_counter()
    outs = []
    for i in range(1, n_frames):
        carry, out = pipe.step(*clouds[i], carry, keys[i])
        outs.append(out)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["nearest_neighbors"]
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
        f"over {steps} steps), K5 launches {launches} ({launches / steps:.1f} per step), K7 "
        f"{ {k: counts[k] for k in ROUNDING} }, "
        f"live tracks {alive}, track ids {sorted(carry.table.tid[carry.table.alive].tolist())} "
        f"[{name}, {smi}]")
    finite = all(bool(torch.isfinite(t).all()) for o in outs
                 for t in (o.transformation, o.fitness, o.residuals))
    finite = finite and bool(torch.isfinite(carry.table.state).all())
    if not finite or launches <= 0 or sum(int(o.moving_count) for o in outs) <= 0:
        raise AssertionError(f"GMFA outputs: finite={finite} launches={launches}")
    need_rounding("GMFA main path", counts, GMFA_ROUNDING)
    # ICP's transform: one launch a call, 30 rounds, the final evaluation and
    # the step's prev_t; no fma32 on this path
    want_tp = (cfg.icp.max_iterations + 2) * steps
    if counts["transform_points"] != want_tp or counts["fma32"]:
        raise AssertionError(f"GMFA main path: transform_points {counts['transform_points']} "
                             f"launches (expected {want_tp}), fma32 {counts['fma32']} (expected 0)")
    return ({k: v for k, v in counts.items() if k == "nearest_neighbors" or k in ROUNDING},
            k5_step_phase(dev, name, smi, pipe, clouds))


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
    flow = ("poly_exp", "blur_solve", "fused_iteration", "warp_matrices", "warp_packed",
            "corner_scale", "level_image")
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
        untimed = [f"{r.get('name')} {k}" for r in res["rows"] for k, v in r.items()
                   if k.startswith(("ms", "device"))
                   and not (v is not None and np.isfinite(v) and v > 0)]
        if missing or untimed:
            raise AssertionError(f"diagnostics.{label}: kernels {missing} not launched, times "
                                 f"{untimed} missing")
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
    tiles = res["tile_probe"]["rounds"]
    if "active" not in tiles or tiles["first"]["visits_total"] <= 0:
        raise AssertionError(f"icp_body tile probe: {tiles}")
    return launches


# ------------------------------------------------------------------ the flow, level by level

def level_rows(dev, name: str, smi: str, frames, c, tag: str) -> dict:
    """K1 at every level of two frames' pyramids, K3 at the levels of at
    least 128x256 and K9 and K2 below them, each ``torch.equal`` to its plain
    version and timed (per call, device µs) beside its bound, K1 also beside
    ``F.conv2d``.  K3 takes a smooth flow, K9 zero flow and K2 K9's M."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
    from datmo_using_optical_flow_tpu_torch.ops import warp

    full = frames[0].to(torch.float32)
    pyr = [fb.build_pyramid(f.to(torch.float32), c.pyr_scale, c.levels, c.poly_n, c.poly_sigma)
           for f in frames[:2]]
    top = len(pyr[0]) - 1
    rows = {"poly_exp": {}, "blur_solve": {}, "fused_iteration": {}, "warp_packed": {},
            "corner_scale": {}}

    def row(kernel, label, got, want, plain, kern, work, lib=None, bits=False):
        err = check(kernel, f"{tag} {label}", got, want, bits)
        ms, plain_ms = time_pair(plain, kern)
        us = kernel_us(kern, dev, f"{kernel} {tag} {label}")
        lib_ms = None if lib is None else library_phase(
            kernel, f"{tag} {label}", lib, want, 1e-3 * float(want.abs().max()), dev, name, smi)
        bound = work.bound_us()
        rows[kernel][f"{label} ({tag})"] = {"ms": ms, "plain_ms": plain_ms, "device_us": us,
                                            "library_ms": lib_ms, "bound_us": bound,
                                            "max_abs_err": err}
        log(f"{kernel} {tag} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device "
            f"{us_text(us)}, bound {bound:.3f} us ({work.bound_by()}), share {share(bound, us)}"
            + ("" if lib_ms is None else f", F.conv2d {lib_ms:.4f} ms") + f" [{name}, {smi}]")

    for level in range(top, -1, -1):
        lh, lw = pyr[0][level].shape[1:]
        label = f"{lh}x{lw}"
        img = fb.level_image(full, c.pyr_scale ** (top - level), lh, lw).contiguous()
        n, s = c.poly_n, c.poly_sigma
        row("poly_exp", label, fk.poly_exp(img, n, s), fk.poly_exp_reference(img, n, s),
            lambda: fk.poly_exp_reference(img, n, s), lambda: fk.poly_exp(img, n, s),
            roofline.poly_exp(lh, lw, n, s), poly_exp_conv(img, n, s))
        R0, R1 = pyr[0][level], pyr[1][level]
        if warp.eligible(lh, lw):
            dx, dy = smooth_flow(lh, lw, dev, amp=2.0)
            row("fused_iteration", label, fk.fused_iteration(R0, R1, dx, dy, c.winsize),
                fk.fused_iteration_reference(R0, R1, dx, dy, c.winsize),
                lambda: fk.fused_iteration_reference(R0, R1, dx, dy, c.winsize),
                lambda: fk.fused_iteration(R0, R1, dx, dy, c.winsize),
                roofline.fused_iteration(lh, lw, c.winsize))
        else:
            zero = torch.zeros((lh, lw), dtype=torch.float32, device=dev)
            scale = fk.corner_scale(R1)
            M = fk.warp_matrices_packed(R0, R1, scale, zero, zero)
            row("warp_packed", label, M, fk.warp_packed_reference(R0, R1, scale, zero, zero),
                lambda: fk.warp_packed_reference(R0, R1, scale, zero, zero),
                lambda: fk.warp_matrices_packed(R0, R1, scale, zero, zero),
                roofline.warp_packed(lh, lw), bits=True)
            row("corner_scale", label, scale, fk.corner_scale_reference(R1),
                lambda: fk.corner_scale_reference(R1), lambda: fk.corner_scale(R1),
                roofline.corner_scale(lh, lw), bits=True)
            rows["corner_scale"][f"{label} ({tag})"]["library_ms"] = library_phase(
                "corner_scale", f"{tag} {label}", *scale_library(R1), 0.0, dev, name, smi)
            row("blur_solve", label, fk.blur_solve(M, c.winsize), fk.blur_solve_reference(
                M, c.winsize), lambda: fk.blur_solve_reference(M, c.winsize),
                lambda: fk.blur_solve(M, c.winsize), roofline.blur_solve(lh, lw, c.winsize))
    return rows


def _flow_launches(h: int, w: int, pairs: int, frames_expanded: int, c,
                   fast_warp: bool = True) -> dict:
    """K1-K4, K8 and K9 launches of ``pairs`` flows over ``frames_expanded``
    expanded frames at (h, w) with Farnebäck settings ``c``: K1 once per level
    and frame, K3 ``iterations`` times per level that ``warp.fused`` runs
    as K3 (those of at least 128x256 and, without ``fast_warp``, the smaller
    ones the exact warp fuses), K2 and the warp on the others (K9, packed, with
    ``fast_warp``, else K4; K9's scale pass once per pair and such level), K8
    once per frame (its level images) and once per pair and level transition
    (the 2-plane upsample)."""
    from datmo_using_optical_flow_tpu_torch.ops import warp
    from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes

    levels = [s[2:] for s in level_sizes(h, w, c.pyr_scale, c.levels)]
    gaussian = bool(c.flags & 256)  # OPTFLOW_FARNEBACK_GAUSSIAN
    k3 = sum(warp.fused(lh, lw, c.winsize, gaussian, fast_warp) for lh, lw in levels)
    small = (len(levels) - k3) * c.iterations * pairs
    scales = (len(levels) - k3) * pairs if fast_warp and c.iterations > 0 else 0
    return {"poly_exp": len(levels) * frames_expanded,
            "fused_iteration": k3 * c.iterations * pairs,
            "blur_solve": small, "warp_packed" if fast_warp else "warp_matrices": small,
            "corner_scale": scales,
            "level_image": frames_expanded + (len(levels) - 1) * pairs}


def _counted(label: str, fn, want: dict):
    """``fn()`` with every launch count set to 0 just before and read just
    after, the card synchronised on both sides; raises unless the counts of
    K1-K6 and K8 are ``want`` (kernels not named: 0).  Returns ``fn()``'s result
    and the counts."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = read_launches()
    expected = {k: want.get(k, 0) for k in tpu_kernels(counts)}
    log(f"{label}: launches {counts}")
    if tpu_kernels(counts) != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    return out, counts


# ------------------------------------------------------------------ pipeline A from points

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
    rows = level_rows(dev, name, smi, bevs, cfg.farneback, "from points")

    launches = {}
    want = _flow_launches(*cfg.grid_shape, n_frames, n_frames, cfg.farneback)
    for q16 in (False, True):
        label = "q16" if q16 else "float32"
        t0 = time.perf_counter()
        summary, counts = _counted(
            f"from points process_files ({label})",
            lambda: pipe.process_files(paths, output_dir=os.path.join(root, f"out_{label}"),
                                       h2d_q16=q16), want)
        elapsed = time.perf_counter() - t0
        per = {k: v / n_frames * 1e3 for k, v in summary["timings"].items()}
        log(f"from points process_files ({label}): {n_frames} frames, {summary['pairs']} pairs, "
            f"{len(summary['tracks'])} tracks, {n_frames / elapsed:.3f} frames/s "
            f"({elapsed / n_frames * 1e3:.3f} ms/frame; runner stages, ms/frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in per.items()) + f") [{name}, {smi}]")
        finite = all(np.isfinite(st).all() for st in summary["tracks"].values())
        if summary["pairs"] != n_frames - 1 or not summary["tracks"] or not finite:
            raise AssertionError(f"from points ({label}): a frame was skipped, or no finite "
                                 f"track came out ({summary['pairs']} pairs)")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

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


# ------------------------------------------------------------------ the reference-API surface

def _host_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn()``, which returns numpy (so it waits for the card)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _np_equal(label: str, got, want) -> None:
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    log(f"compat {label}: card {'equals' if same else 'DIFFERS FROM'} the CPU")
    if not same:
        raise AssertionError(f"compat {label}: the card differs from the CPU")


def _flow_close(label: str, got, want) -> None:
    """The flow's velocities within 1e-4 and its curl within 2e-4 of the
    CPU's (``tests/test_torch_compat.py``'s limits)."""
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    log(f"compat {label}: card vs CPU vx/vy/curl max_abs_err {errs[0]:.3e}/{errs[1]:.3e}/"
        f"{errs[2]:.3e} (tol 1e-4/1e-4/2e-4){'; bit-equal' if same else ''}")
    if errs[0] > 1e-4 or errs[1] > 1e-4 or errs[2] > 2e-4:
        raise AssertionError(f"compat {label}: the card's flow differs from the CPU's")


def compat_phase(dev, name: str, smi: str, root: str, gclouds) -> dict:
    """The reference-API surface on the card (``compat``, ``ops/nn``), each
    part against the port on the CPU: ``compute_velocity_vectors`` on two
    200x200 BEVs of ``benchmarks/from_points.py``'s scene (``preprocess_pcd``
    on the card, equal to the CPU's) and on two ``make_frames`` 1080x1920
    frames, each with the launches its level sizes give; the propagation
    masks, DBSCAN and the road filter on the 200x200 flow;
    ``process_multiple_frames`` over 4 of the from-points files with seeds 0
    and 5; ``align_by_nearest`` on GMFA's preprocessed clouds (one K5 launch
    per call); ``nearest_neighbors_scan`` at 300,000 targets and 4,096
    queries against a float64 ``cKDTree`` and the CPU, timed.  The plots are
    not drawn: this machine has no matplotlib.  Returns the launches."""
    from scipy.spatial import cKDTree

    from datmo_using_optical_flow_tpu_torch import compat
    from datmo_using_optical_flow_tpu_torch.benchmarks import from_points as fpb
    from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
    from datmo_using_optical_flow_tpu_torch.io.frames import pcd_files_in
    from datmo_using_optical_flow_tpu_torch.ops import nn
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames

    t_phase = time.perf_counter()
    cfg, fb = fpb.config(), FarnebackConfig()
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    paths = pcd_files_in(os.path.join(root, "seq"))[:4]
    pre = (cfg.grid_resolution, cfg.x_range, cfg.y_range, cfg.z_max, cfg.roi_bounds)
    bevs = [compat.preprocess_pcd(p, *pre, seed=i) for i, p in enumerate(paths[:2])]
    _np_equal("preprocess_pcd (frames 0, 1; seeds 0, 1)", bevs,
              [compat.preprocess_pcd(p, *pre, seed=i, device="cpu")
               for i, p in enumerate(paths[:2])])
    for label, (im1, im2), ranges in (
            ("200x200 from-points BEVs", bevs, (cfg.x_range, cfg.y_range)),
            ("1080x1920 make_frames", make_frames(2, 1080, 1920), ((0, 1920), (0, 1080)))):
        h, w = im1.shape
        got, counts = _counted(f"compat compute_velocity_vectors {label}", lambda: compat.
                               compute_velocity_vectors(im1, im2, *ranges),
                               _flow_launches(h, w, 1, 2, fb, fast_warp=False))
        add(counts)
        cpu = compat.compute_velocity_vectors(im1, im2, *ranges, device="cpu")
        _flow_close(f"compute_velocity_vectors {label}", got, cpu)
        ms = _host_ms(lambda: compat.compute_velocity_vectors(im1, im2, *ranges))
        speed = np.hypot(got[0], got[1])
        log(f"compat compute_velocity_vectors {label}: {ms:.3f} ms per call on the card, numpy "
            f"in and out (median of 5), launches {counts} as the level sizes predict; |v| max "
            f"{speed.max():.3f} [{name}, {smi}]")
        if not all(np.isfinite(a).all() for a in got) or speed.max() <= 0:
            raise AssertionError(f"compat {label}: no finite, moving flow")

    vx, vy, _ = compat.compute_velocity_vectors(*bevs, cfg.x_range, cfg.y_range)
    res = cfg.grid_resolution
    ax, ay = np.gradient(vx)[0] * 10, np.gradient(vy)[1] * 10
    valid = np.hypot(vx, vy) > 0.1
    road = np.array([[0, 0], [110, 0], [60, 100], [110, 200], [0, 200]], np.float32)
    card_cpu = {}
    for dev_name in ("cuda", "cpu"):
        masks = (compat.propagation_mask(vx, vy, 0.1, res, 0.5, device=dev_name),
                 compat.propagation_mask_with_acceleration(vx, vy, ax, ay, 0.1, res, 0.5,
                                                           device=dev_name),
                 compat.continuity_mask(vx, vy, 0.5, device=dev_name))
        labels, idx = compat.dbscan_clustering(vx, vy, valid, eps=5.0, min_samples=5,
                                               device=dev_name)
        kept = compat.filter_clusters_by_roi(labels, idx, (vx, vy), valid, road,
                                             device=dev_name)
        card_cpu[dev_name] = (*masks, labels, idx, *kept)
    _np_equal(f"masks, dbscan_clustering ({int(valid.sum())} cells, "
              f"{len(set(card_cpu['cuda'][3].tolist()) - {-1})} clusters) and "
              f"filter_clusters_by_roi ({len(card_cpu['cuda'][5])} cells kept) on the 200x200 "
              "flow", card_cpu["cuda"], card_cpu["cpu"])
    clustered = int((card_cpu["cuda"][3] >= 0).sum())
    if not 0 < len(card_cpu["cuda"][5]) < clustered:
        raise AssertionError(f"compat: the road filter kept {len(card_cpu['cuda'][5])} of "
                             f"{clustered} clustered cells")

    for seed in (0, 5):
        t0 = time.perf_counter()
        got, counts = _counted(
            f"compat process_multiple_frames seed {seed}",
            lambda: compat.process_multiple_frames(
                paths, cfg, output_dir=os.path.join(root, f"compat_card_{seed}"), seed=seed),
            _flow_launches(*cfg.grid_shape, len(paths), len(paths), cfg.farneback))
        fps = len(paths) / (time.perf_counter() - t0)
        add(counts)
        want = compat.process_multiple_frames(
            paths, cfg, output_dir=os.path.join(root, f"compat_cpu_{seed}"), seed=seed,
            device="cpu")
        same_ids = set(got) == set(want) and len(want) > 0
        err = max((float(np.abs(got[t] - s).max()) for t, s in want.items()), default=0.0) \
            if same_ids else None
        log(f"compat process_multiple_frames seed {seed}, 4 frames: tracks "
            f"{sorted(got)}/{sorted(want)} (card/CPU), state max_abs_err {err} (tol 5e-3), "
            f"{fps:.3f} frames/s on the card (a 4-frame run: preprocess, steps and artifacts) "
            f"[{name}, {smi}]")
        if not same_ids or err > 5e-3:
            raise AssertionError(f"compat process_multiple_frames seed {seed}: the card's "
                                 "tracks differ from the CPU's")

    (p1, _), (p0, m0) = gclouds[1], gclouds[0]
    aligned, counts = _counted(f"compat align_by_nearest ({p1.shape[0]} points)",
                               lambda: nn.align_by_nearest(p1, p0, m0), {"nearest_neighbors": 1})
    add(counts)
    if not torch.isfinite(aligned).all():
        raise AssertionError("compat align_by_nearest: non-finite points")
    # the same call on 16,384 rows of cloud 1 on both devices (the full cloud
    # takes ~65 s on the CPU; a row's winner at a near-tie depends on its
    # block, so the card's full run and a CPU run on a subset may differ)
    part = p1[:16384]
    _np_equal("align_by_nearest (16,384 rows of cloud 1 onto cloud 0)",
              [nn.align_by_nearest(part, p0, m0).cpu().numpy()],
              [nn.align_by_nearest(part.cpu(), p0.cpu(), m0.cpu()).numpy()])

    tgt = torch.cat([c[0] for c in gclouds[:3]])[:300_000]
    tmask = torch.cat([c[1] for c in gclouds[:3]])[:300_000]
    src = gclouds[3][0][gclouds[3][1]][:4096]
    idx, d2 = nn.nearest_neighbors_scan(src, tgt, tmask)
    lo = nn._scan_lower_bound(src, tgt, tmask, d2)
    s64, t64 = src.cpu().double().numpy(), tgt.cpu().double().numpy()
    tm = tmask.cpu().numpy()
    true_d, _ = cKDTree(t64[tm]).query(s64)
    true_d2 = true_d ** 2
    # the envelope _scan_lower_bound subtracts, before its clamp at 0
    env = 2e-6 * ((s64 ** 2).sum(1) + (t64[tm] ** 2).sum(1).max()) + 1e-6
    at_idx = ((s64 - t64[idx.cpu().long().numpy()]) ** 2).sum(1)
    d2_err = np.abs(d2.cpu().double().numpy() - true_d2)
    sound = bool((lo.cpu().double().numpy() <= true_d2).all())
    ok = sound and bool((d2_err <= env).all()) and bool((at_idx - true_d2 <= 2 * env).all()) \
        and bool(tm[idx.cpu().long().numpy()].all())
    c_idx, c_d2 = nn.nearest_neighbors_scan(src.cpu(), tgt.cpu(), tmask.cpu())
    cpu_err = float(torch.max(torch.abs(c_d2 - d2.cpu())))
    same_idx = float((c_idx == idx.cpu()).float().mean())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(7):
        start.record()
        nn.nearest_neighbors_scan(src, tgt, tmask)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    scan_ms = statistics.median(times[2:])
    log(f"nearest_neighbors_scan, 4,096 queries x 300,000 targets: {scan_ms:.3f} ms per call "
        f"(CUDA events, median of 5 after 2 warm-up calls); vs float64 cKDTree: bound sound "
        f"{sound}, d2 max_abs_err {d2_err.max():.3e} within the envelope (max "
        f"{env.max():.3e}), winners within twice it; vs the CPU: d2 max_abs_err "
        f"{cpu_err:.3e}, indices equal on {same_idx:.4f} of rows [{name}, {smi}]")
    if not ok or cpu_err > float(env.max()):
        raise AssertionError("nearest_neighbors_scan: outside the envelope of the true NN")
    log(f"compat phase: plots not drawn on this machine (no matplotlib; "
        f"tests/test_torch_viz.py runs them on the CPU); launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _bench_process(label: str, args: list, timeout: float = 300.0) -> dict:
    """One benchmark of the port in its own process (``python -m``), as a
    user runs it; returns its JSON record, the last line of its output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"datmo_using_optical_flow_tpu_torch."
                           f"benchmarks.{label}", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"benchmarks.{label} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"benchmarks.{label} {' '.join(args)} ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(rec)}")
    return rec


def benchmarks_phase() -> dict:
    """The port's three benchmarks once each, shortened (9 frames and 1 sweep
    at 1080x1920, 6 frames from points, 4 GMFA frames and 1 sweep), each run
    as a user runs it: its own
    process (``python -m``), whose last line of output is its JSON record.
    A fresh process also keeps the benchmark's profiler traces out of this
    long one (late in it, traces have lost their first records)."""
    out = {}
    for label, args in (("stream_1080p", ["--frames", "9", "--sweeps", "1"]),
                        ("from_points", ["--frames", "6"]),
                        ("gmfa_reference_load", ["--frames", "4", "--sweeps", "1"])):
        rec = _bench_process(label, args)
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"benchmarks.{label}: no rate")
        out[label] = rec
    return out


# ------------------------------------------------------------------ K7 (once-rounded fma)

def _sig(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else "number"


def _keep(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def round_cases(runs) -> dict:
    """Each ``runs`` callable run once on the card (not counted) with every K7
    wrapper call's inputs recorded: the first call of each signature (kernel,
    operand shapes, root; for the sum of squares also its call site) is
    kept, and for ICP's transform also the last (a converged transform)."""
    from unittest import mock

    from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

    cases, fma_orig, sumsq_orig, tp_orig = {}, rk._fma32, rk._sumsq, rk._transform_points

    def fma_rec(a, b, c, root):
        key = ("fma32", _sig(a), _sig(b), _sig(c), root)
        if key not in cases:  # an operand passed twice stays one tensor (its bytes once)
            ka = _keep(a)
            cases[key] = (ka, ka if b is a else _keep(b), ka if c is a else _keep(c), root)
        return fma_orig(a, b, c, root)

    def sumsq_rec(a, b, root):
        # the call site: the frame that called sumsq_fma / norm_rn (or _norm3)
        f = sys._getframe(2)
        if f.f_code.co_name == "_norm3":
            f = f.f_back
        site = f"{os.path.relpath(f.f_code.co_filename, ROOT)}:{f.f_lineno}"
        cases.setdefault(("sumsq", _sig(a), None if b is None else _sig(b), root, site),
                         (a.clone(), None if b is None else b.clone(), root))
        return sumsq_orig(a, b, root)

    def tp_rec(points, transformation):
        sig = ("transform_points", _sig(points), _sig(transformation))
        kept = (points.clone(), transformation.clone())
        cases.setdefault((*sig, "first"), kept)
        cases[(*sig, "last")] = kept
        return tp_orig(points, transformation)

    with mock.patch.object(rk, "_fma32", fma_rec), mock.patch.object(rk, "_sumsq", sumsq_rec), \
            mock.patch.object(rk, "_transform_points", tp_rec):
        for run in runs:
            run()
    torch.cuda.synchronize()
    return cases


def round_runs(dev, gpipe, gclouds) -> tuple:
    """The main paths' steps whose K7 inputs :func:`round_cases` records:
    pipeline A's stream step at 1080x1920 (a priming frame, then one step)
    and GMFA's step at reference load on clouds 0 -> 1."""
    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
    from datmo_using_optical_flow_tpu_torch.utils import prng

    pipe = PipelineA(config(1080, 1920), dev, fast_warp=True)
    bevs = [torch.as_tensor(f, device=dev) for f in make_frames(2, 1080, 1920)]

    def a_step():
        carry = pipe.init_stream_carry()
        for f in bevs:
            carry, _ = pipe.step_stream(f, carry)

    return (a_step, lambda: gpipe.step(*gclouds[1], gpipe.seed_carry(*gclouds[0]),
                                       prng.PRNGKey(0)))


def _transform_special(dev, n: int = 102400, seed: int = 24) -> list:
    """ICP's transform on points the recorded steps do not give: infinities,
    NaNs, signed zeros, subnormals and float32's extremes among uniform
    coordinates, and sums that land within a float64 half-ulp of a float32
    midpoint (``tests/test_torch_icp.py::_near_midpoints``: r = (1 - a 2^-23)
    2^-24 and y = (1 + a 2^-23) 2^e, so a sum rounded twice goes the wrong
    way), each with a small rotation about z and a shift.  (label, points,
    transform) on the card."""
    rng = np.random.default_rng(seed)
    c, s = np.cos(0.03), np.sin(0.03)
    rot = np.eye(4, dtype=np.float32)
    rot[:2, :2] = [[c, -s], [s, c]]
    rot[:3, 3] = [0.4, -0.2, 0.05]
    pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    special = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -3e-39, 3.4e38, -3.4e38])
    pick = rng.random((n, 3)) < 0.3
    pts[pick] = rng.choice(special, int(pick.sum()))
    a = int(rng.integers(1, 300))
    mid = np.eye(4, dtype=np.float32)
    mid[0, 1] = mid[1, 2] = np.float32((1 - a * 2.0 ** -23) * 2.0 ** -24)
    mid[1, :2] = [1, 0]
    mid[:3, 3] = rng.uniform(-1, 1, 3)
    e = rng.integers(-3, 5, n)
    sign = [rng.choice([-1.0, 1.0], n) for _ in range(3)]
    x = sign[0] * rng.uniform(1, 2, n) * 2.0 ** e
    y, z = (sg * (1 + (a + rng.integers(-1, 2, n)) * 2.0 ** -23) * 2.0 ** e for sg in sign[1:])
    near = np.stack([x, y, z], axis=1).astype(np.float32)
    return [(label, torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev))
            for label, p, t in (("special values", pts, rot), ("near float32 midpoints", near,
                                                                 mid))]


def _distinct(t) -> int:
    """The distinct values a (possibly expanded) view reads: 0-stride axes once."""
    return int(np.prod([n for n, st in zip(t.shape, t.stride()) if st != 0]))


def round_phase(dev, name: str, smi: str, cases: dict) -> dict:
    """K7 against its plain version, bit for bit, on every recorded input of
    the main paths and on operands with infinities, NaNs, signed zeros,
    subnormals and float32's extremes (the sum of squares of one operand, of
    a difference and of a difference with a broadcast row).  The fma is
    timed at its largest recorded input (CUDA events, and its device µs from
    the profiler), with its bound and ``torch.addcmul``; the sum of squares
    at every recorded call site, each in its own row (``micro_flow.
    sumsq_library`` beside it), and the kernels line takes tracker A's
    association distance, the 1080p main path's site."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow import sumsq_library
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

    gen = torch.Generator(device=dev).manual_seed(7)
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0, 1e-40,
                            -3e-39, 3.4e38, -3.4e38, 1.0, 1e-20, 1e20], device=dev)
    pick = torch.randint(0, special.numel(), (3, 4096), device=dev, generator=gen)
    a, b, c = (special[pick[i]] * torch.rand(4096, device=dev, generator=gen).add(0.5)
               for i in range(3))
    cases = dict(cases)
    # ICP's transform on special values and near midpoints, and through views
    # (transposed points, a transform inside a larger matrix); the parent's
    # ICP fma32 signature, (N, 1) x (3,) + (N, 3), read through its strides
    tp = [(k, case) for k, case in cases.items() if k[0] == "transform_points"]
    if not tp:
        raise AssertionError("transform_points: GMFA's step made no call")
    for label, pts, tr in _transform_special(dev):
        cases[("transform_points", label)] = (pts, tr)
    pts, tr = tp[-1][1]
    big = torch.zeros((6, 6), device=dev)
    big[1:5, 2:6] = tr
    cases[("transform_points", "views")] = (pts.T.contiguous().T, big[1:5, 2:6])
    cases[("fma32", "icp broadcast", False)] = (pts[:, 1:2], tr[:3, 1], pts[:, :1] * tr[:3, 0],
                                                False)
    v, w = torch.stack([a, b, c], dim=1), torch.stack([c, a, b], dim=1)
    for root in (False, True):
        cases[("fma32", "special", root)] = (a, b, c, root)
        cases[("sumsq", "special", None, root, "special")] = (v, None, root)
        cases[("sumsq", "special", "difference", root, "special")] = (v, w, root)
        cases[("sumsq", "special", "broadcast row", root, "special")] = (v, w[7], root)
    out = {}
    for key, case in cases.items():
        kernel = key[0]
        if kernel == "fma32":
            got, want = rk._fma32(*case), rk.fma32_reference(*case)
        elif kernel == "transform_points":
            got, want = rk._transform_points(*case), rk.transform_points_reference(*case)
        else:
            x, y, root = case
            got = rk._sumsq(x, y, root)
            want = rk.sumsq_reference(x, root) if y is None else rk.sumsq_diff_reference(
                x, y, root)
        if not rk.bits_equal(got, want):
            raise AssertionError(f"{kernel} {key[1:]}: the kernel differs from its plain version")
        res = out.setdefault(kernel, {"max_abs_err": 0.0, "cases": 0, "numel": -1})
        res["cases"] += 1
        if kernel == "fma32" and key[1] not in ("special", "icp broadcast") \
                and got.numel() > res["numel"]:
            res["numel"], res["case"] = got.numel(), case
        if kernel == "sumsq" and key[-1] != "special":
            res.setdefault("sites", {})[key] = case
    for kernel, res in out.items():
        log(f"{kernel}: bit-equal to its plain version on {res['cases']} inputs (the main "
            f"paths' and special values)")
    res = out["fma32"]
    a, b, c, root = res.pop("case")
    fns = (lambda: rk.fma32_reference(a, b, c, root), lambda: rk._fma32(a, b, c, root))
    lib = None if root or not all(isinstance(x, torch.Tensor) for x in (b, c)) else (
        lambda: torch.addcmul(c, a, b))
    inputs = len({x.data_ptr() for x in (a, b, c) if isinstance(x, torch.Tensor)})
    _time_round(res, "fma32", f"{tuple(a.shape)}, {_sig(b)}, {_sig(c)}, root={root}", fns, lib,
                roofline.fma32(res["numel"], inputs, root), None, dev, name, smi)
    out["transform_points"].pop("numel")
    transform_phase(out, tp[-1][1], cases[("fma32", "icp broadcast", False)], dev, name, smi)
    res = out["sumsq"]
    sites = res.pop("sites")
    res.pop("numel")
    rows = {}
    for key, (x, y, root) in sites.items():
        site = key[-1]
        label = f"{site} {tuple(x.shape)}{'' if y is None else f' - {tuple(y.shape)}'}, " \
                f"root={root}"
        rows_n = x.shape[:-1].numel() if y is None else torch.broadcast_shapes(
            x.shape, y.shape)[:-1].numel()
        k = x.shape[-1]
        work = (roofline.sumsq(rows_n, k, root) if y is None else
                roofline.sumsq_diff(_distinct(x), _distinct(y), rows_n, k, root))
        fns = ((lambda x=x, root=root: rk.sumsq_reference(x, root)) if y is None else
               (lambda x=x, y=y, root=root: rk.sumsq_diff_reference(x, y, root)),
               lambda x=x, y=y, root=root: rk._sumsq(x, y, root))
        row = {"site": site, "a": list(x.shape), "b": None if y is None else list(y.shape),
               "root": root, "difference": y is not None}
        # a distance call stands beside a site without the root: held to its root
        _time_round(row, "sumsq", label, fns, sumsq_library(x, y, root), work,
                    rk.sqrt_rn if y is not None and not root else None, dev, name, smi)
        rows[label] = row
    res["sites"] = rows
    main = [r for r in rows.values() if "tracker_a.py" in r["site"]]
    if not main:
        raise AssertionError("sumsq: tracker A's association distance was not recorded")
    res.update({k: main[0][k] for k in ("ms", "plain_ms", "device_us", "library_ms", "work")})
    res["main_site"] = main[0]["site"]
    return out


def transform_phase(out: dict, case: tuple, broadcast: tuple, dev, name: str, smi: str) -> None:
    """ICP's transform on the card at GMFA's last recorded call (102,400
    points, a converged transform): ``ops/icp.transform_points`` is one launch
    of the new kernel (no fma32), one device record, and no host sync under
    ``torch.cuda.set_sync_debug_mode("error")``; so is fma32 at the parent's
    broadcast ICP signature.  Then timed (``_time_round``) beside the plain
    version and ``torch.addmm(t, points, R.T)`` (TF32 off), with its bound."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow import records_per_call
    from datmo_using_optical_flow_tpu_torch.ops import icp as icp_ops
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

    pts, tr = case
    call = lambda: icp_ops.transform_points(pts, tr)  # noqa: E731
    bcall = lambda: rk._fma32(*broadcast)  # noqa: E731
    before = dict(rk.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        bcall()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    made = {k: rk.LAUNCHES[k] - before[k] for k in before}
    # the most records of three readings: a lost record reads fewer, a copy more
    records = [max(records_per_call(fn, dev) for _ in range(3)) for fn in (call, bcall)]
    log(f"transform_points at {tuple(pts.shape)}: launches {made} for one call each of it and "
        f"of fma32 at {[_sig(x) for x in broadcast[:3]]}; device records per call "
        f"{records[0]:g} / {records[1]:g}; no host sync (sync debug mode 'error')")
    if made != {"fma32": 1, "sumsq": 0, "transform_points": 1} or records != [1.0, 1.0]:
        raise AssertionError(f"transform_points: launches {made}, records {records}; expected "
                             f"one launch and one record each")
    res = out["transform_points"]
    res["records"], res["fma32_broadcast_records"] = records
    r, t = tr[:3, :3].T, tr[:3, 3]
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    _time_round(res, "transform_points", f"{tuple(pts.shape)}",
                (lambda: rk.transform_points_reference(pts, tr), call),
                lambda: torch.addmm(t, pts, r), roofline.transform_points(pts.shape[0]), None,
                dev, name, smi)


def _time_round(res: dict, kernel: str, label: str, fns, lib, work, lib_of, dev, name: str,
                smi: str) -> None:
    """A K7 row: the kernel and its plain version per call in turns, the
    kernel's device µs, one library call (held within 1e-5 of the plain
    version's largest finite value, after ``lib_of`` where the library
    computes a root of it), the work and its bound; logged."""
    res["ms"], res["plain_ms"] = time_pair(*fns)
    res["device_us"] = kernel_us(fns[1], dev, kernel)
    want = fns[0]()
    if lib_of is not None:
        want = lib_of(want)
    res["library_ms"] = None if lib is None else library_phase(
        kernel, label, lib, want, 1e-5 * float(want[torch.isfinite(want)].abs().max()),
        dev, name, smi)
    res["work"] = work
    log(f"{kernel} at {label}: kernel {res['ms']:.4f} ms, device {us_text(res['device_us'])}, "
        f"plain {res['plain_ms']:.4f} ms, library "
        f"{'none' if res['library_ms'] is None else format(res['library_ms'], '.4f')} ms, "
        f"bound {work.bound_us():.3f} us ({work.bound_by()}), share "
        f"{share(work.bound_us(), res['device_us'])} [{name}, {smi}]")


# ------------------------------------------------------------------ ICP's options

def _icp_equal(label: str, got, want) -> None:
    """Raise unless two ``IcpResult`` are equal field by field."""
    bad = [f for f, g, w in zip(got._fields, got, want) if not torch.equal(g.cpu(), w.cpu())]
    log(f"ICP {label}: card {'equals' if not bad else 'DIFFERS FROM'} the CPU "
        f"(iterations {int(got.iterations)}, fitness {float(got.fitness):.6f}, stats "
        f"{[int(x) for x in got.sweep_stats.tolist()]})")
    if bad:
        raise AssertionError(f"ICP {label}: the card differs from the CPU in {bad}")


def _icp_case(seed: int, n: int, yaw: float, shift, noise: float, pad: int):
    """A uniform cloud, its rigid move plus noise, both padded with 1e9 rows."""
    rng = np.random.default_rng(seed)
    cloud = rng.uniform(-15, 15, size=(n, 3)).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    target = (cloud @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + np.asarray(shift)
              + rng.normal(scale=noise, size=cloud.shape)).astype(np.float32)
    src, dst = (np.full((pad, 3), 1e9, np.float32) for _ in range(2))
    src[:n], dst[:n] = cloud, target
    mask = np.zeros(pad, bool)
    mask[:n] = True
    return tuple(torch.from_numpy(a) for a in (src, mask, dst, mask))


def icp_options_phase(dev, name: str, smi: str, pair, icp_cfg) -> dict:
    """ICP's options on the card: ``coarse_stride=4`` and ``sweep="inplace"``
    on small clouds equal to the CPU run field by field; at GMFA's reference
    load (frames 0 -> 1), ``diagnostics/icp_sound``'s violation counts (all
    must be 0) and one cached ICP per sweep, compact and in place, timed with
    K5's device ms (``icp_body --sweeps``, in a process of its own).
    Returns the launches and that comparison."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import icp_sound
    from datmo_using_optical_flow_tpu_torch.ops import icp as icp_ops

    t0 = time.perf_counter()
    counts: dict = {}
    for label, case, kw in (
            ("coarse_stride=4 (4096 points, 0.5 m)",
             _icp_case(0, 4096, 0.02, [0.1, -0.05, 0.02], 0.02, 4096),
             dict(threshold=0.5, coarse_stride=4)),
            ("sweep=inplace (3000 of 4096 points, 0.05 m)",
             _icp_case(11, 3000, 0.01, [0.05, -0.03, 0.01], 0.01, 4096),
             dict(threshold=0.05, cached=True, sweep="inplace")),
            ("sweep=inplace (3000 of 4096 points, 0.5 m)",
             _icp_case(11, 3000, 0.01, [0.05, -0.03, 0.01], 0.01, 4096),
             dict(threshold=0.5, cached=True, sweep="inplace"))):
        want = icp_ops.registration_icp(*case, **kw)  # the CPU's, outside the count
        card = tuple(t.to(dev) for t in case)
        torch.cuda.synchronize()
        reset_launches()
        got = icp_ops.registration_icp(*card, **kw)
        torch.cuda.synchronize()
        c = read_launches()
        # one K5 query per round of each phase (frozen rounds too), one at the end
        k5_want = (2 if "coarse_stride" in kw else 1) * 30 + 1
        log(f"ICP {label}: launches {c} (K5 expected {k5_want})")
        if c["nearest_neighbors"] != k5_want:
            raise AssertionError(f"ICP {label}: K5 launched {c['nearest_neighbors']} times, "
                                 f"expected {k5_want}")
        need_rounding(f"ICP {label}", c, GMFA_ROUNDING)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        _icp_equal(label, got, want)
    report = icp_sound.probe(*pair[0], *pair[1], icp_cfg.threshold)  # not counted
    log(f"icp_sound at reference load: {report} [{name}, {smi}]")
    if icp_sound.violations(report):
        raise AssertionError(f"icp_sound: violations {report}")
    log(f"icp_sound: {icp_sound.strict_violations(report)} winners farther than the truth by "
        f"over 1e-6 (the JAX probe's tolerance), all within K5's envelope")
    # the sweep comparison in a process of its own: late in this one the
    # profiler loses kernel records (PERF.md §7)
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "datmo_using_optical_flow_tpu_torch.diagnostics.icp_body", "--sweeps"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"icp_body --sweeps exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(f"  {line}")
    ab = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"ICP sweeps at reference load ({time.perf_counter() - t1:.1f} s, its own process): "
        f"compact {ab['compact']['ms']:.3f} ms per ICP, K5 {ab['compact']['k5_device_ms']} ms; "
        f"in place {ab['inplace']['ms']:.3f} ms, K5 {ab['inplace']['k5_device_ms']} ms; "
        f"|T_inplace - T_compact| {ab['inplace_vs_compact']:.3e} [{name}, {smi}]")
    log(f"ICP options phase: launches {counts}, {time.perf_counter() - t0:.1f} s")
    return counts, ab


# ------------------------------------------------------------------ stream-parallel paths

def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for leaf in tree for x in _leaves(leaf)]
    return [tree]


def _tree_equal(label: str, got, want) -> None:
    """Raise unless every leaf is equal (NaN where NaN)."""
    bad = sum(not (torch.equal(g, w) or (g.is_floating_point() and torch.equal(
        torch.nan_to_num(g, nan=1.5), torch.nan_to_num(w, nan=1.5))))
        for g, w in zip(_leaves(got), _leaves(want), strict=True))
    if bad:
        raise AssertionError(f"{label}: {bad} leaves differ")


def streams_phase(dev, name: str, smi: str, gclouds) -> dict:
    """``parallel/streams`` on the card: pipeline A's frame-pair step and its
    stream-mode step over 4 feeds at 1080x1920 (``bench.py``'s configuration;
    feed s is ``make_frames(., seed=s)``) and GMFA's step over 4 feeds at
    reference load (feed s steps cloud s -> s + 1 of ``gmfa_reference_load``'s
    frames, one step after seeding).  Each single-stream step on each feed
    runs first, each with the launch counts set to 0 just before it and read
    just after; then the multi-stream step, counted alone the same way.
    Every feed's outputs and carry equal the single-stream step's, the
    metrics equal the sums, and the multi-stream step's launches equal the
    sum of the single-stream steps' (K1-K5 and K7 alike).  Then
    ``benchmarks/multistream_4x1080p`` in a process of its own.  Returns the
    multi-stream steps' launches."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import gmfa_reference_load as grl
    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.parallel import streams
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
    from datmo_using_optical_flow_tpu_torch.utils import prng
    from datmo_using_optical_flow_tpu_torch.utils.tree import unstack

    n = 4
    launches: dict = {}

    def counted(fn):
        """``fn()`` and the launches it made, counted alone."""
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, read_launches()

    def singles(fns):
        """Each feed's single-stream run, counted alone; their outputs and summed launches."""
        outs, total = [], {}
        for fn in fns:
            out, c = counted(fn)
            outs.append(out)
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        return outs, total

    def multi(label, fn, want, kernels):
        t0 = time.perf_counter()
        out, c = counted(fn)
        log(f"streams {label}: launches {c}, the single-stream steps' {want}, "
            f"{time.perf_counter() - t0:.1f} s")
        if c != want or any(c[k] <= 0 for k in kernels):
            raise AssertionError(f"streams {label}: launches {c}, expected the single-stream "
                                 f"steps' {want} with {kernels} launched")
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        return out

    cfg = config()
    frames = np.stack([make_frames(3, 1080, 1920, seed=s) for s in range(n)])
    bevs = [torch.as_tensor(frames[:, t], device=dev) for t in range(3)]
    single = PipelineA(cfg, dev, fast_warp=True)
    flow = ("poly_exp", "blur_solve", "fused_iteration", "warp_packed", "corner_scale",
            "level_image", *A_ROUNDING)

    # A's frame-pair step
    ref, want = singles([lambda s=s: single.step(bevs[0][s], bevs[1][s], single.init_carry())
                         for s in range(n)])
    step = streams.make_multi_stream_step(cfg, fast_warp=True, device=dev)
    carry, outs, metrics = multi(
        "A frame-pair step", lambda: step(bevs[0], bevs[1], streams.init_stream_carry(cfg, n, dev)),
        want, flow)
    for s, (c1, o1) in enumerate(ref):
        _tree_equal(f"A frame-pair feed {s}", unstack(outs, s), o1)
        _tree_equal(f"A frame-pair carry {s}", unstack(carry, s), c1)
    cells, tracks = int(metrics["total_cells"]), int(metrics["total_tracks"])
    if (cells != int(outs.cell_count.sum()) or tracks != int(carry.table.alive.sum())
            or cells <= 0):
        raise AssertionError(f"A metrics {cells}, {tracks}")
    log(f"streams A frame-pair step, 4x1080x1920: every feed equals PipelineA.step on the "
        f"card; total_cells {cells} (per feed {outs.cell_count.tolist()}), total_tracks "
        f"{tracks}")

    # A's stream mode, 3 frames
    def feed_stream(s):
        c1, outs1 = single.init_stream_carry(), []
        for t in range(3):
            c1, o1 = single.step_stream(bevs[t][s], c1)
            outs1.append(o1)
        return c1, outs1

    def stream_mode():
        step = streams.make_stream_mode_step(cfg, fast_warp=True, device=dev)
        carry, outs = streams.init_stream_mode_carry(cfg, n, dev), []
        for t in range(3):
            carry, out, cells = step(bevs[t], carry)
            outs.append(out)
        return carry, outs, cells

    ref, want = singles([lambda s=s: feed_stream(s) for s in range(n)])
    carry, outs, cells = multi("A stream-mode step", stream_mode, want, flow)
    for s, (c1, outs1) in enumerate(ref):
        for t in range(3):
            _tree_equal(f"A stream-mode feed {s} frame {t}", unstack(outs[t], s), outs1[t])
        _tree_equal(f"A stream-mode carry {s}", unstack(carry, s), c1)
    log(f"streams A stream-mode step, 4x1080x1920, 3 frames: every feed equals "
        f"PipelineA.step_stream on the card; cells {int(cells)}")

    # GMFA's step
    gcfg = grl.config()
    gpipe = GMFAPipeline(gcfg, grl.MAX_MOVING, dev)
    prev = torch.stack([gclouds[s][0] for s in range(n)])
    prev_m = torch.stack([gclouds[s][1] for s in range(n)])
    cur = torch.stack([gclouds[s + 1][0] for s in range(n)])
    cur_m = torch.stack([gclouds[s + 1][1] for s in range(n)])
    keys = torch.stack([prng.fold_in(prng.PRNGKey(0), 100 + s) for s in range(n)])
    ref, want = singles([lambda s=s: gpipe.step(cur[s], cur_m[s],
                                                gpipe.seed_carry(prev[s], prev_m[s]), keys[s])
                         for s in range(n)])

    def gmfa_step():
        step = streams.make_multi_stream_gmfa_step(gcfg, grl.MAX_MOVING, dev)
        carry = streams.seed_gmfa_stream_carry(streams.init_gmfa_stream_carry(gcfg, n, dev),
                                               prev, prev_m)
        return step(cur, cur_m, carry, keys)

    carry, outs, metrics = multi("GMFA step", gmfa_step, want,
                                 ("nearest_neighbors", *GMFA_ROUNDING))
    for s, (c1, o1) in enumerate(ref):
        _tree_equal(f"GMFA feed {s}", unstack(outs, s), o1)
        _tree_equal(f"GMFA carry {s}", unstack(carry, s), c1)
    moving, tracks = int(metrics["total_moving"]), int(metrics["total_tracks"])
    if (moving != int(outs.moving_count.sum()) or tracks != int(carry.table.alive.sum())
            or moving <= 0):
        raise AssertionError(f"GMFA metrics {moving}, {tracks}")
    log(f"streams GMFA step, 4 feeds x 102,400 points: every feed equals "
        f"GMFAPipeline.step on the card; total_moving {moving} (per feed "
        f"{outs.moving_count.tolist()}), total_tracks {tracks}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "datmo_using_optical_flow_tpu_torch.benchmarks.multistream_4x1080p"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"benchmarks.multistream_4x1080p exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"benchmarks.multistream_4x1080p ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(rec)} [{name}, {smi}]")
    log(f"  {proc.stderr.strip().splitlines()[-1]}")
    if not (np.isfinite(rec["value"]) and rec["value"] > 0):
        raise AssertionError("benchmarks.multistream_4x1080p: no rate")
    return launches


# ------------------------------------------------------------------ the last missing paths

# K1's tiny form's cases (h, w, poly_n, sigma): every rule of its plan, tall
# (122x5, 1088x5, 300x7) and wide (2x1920, 7x300) images that spread over
# many blocks, the compile-time taps and the runtime-n kernel's (sigma 0.3);
# shapes at poly_n 5 with more than 5 rows and columns take the wide form.
# Then ROADMAP Queue 3 item 8's shapes, where the plan is not yet XLA's (with
# 5x5 at sigma 5.0 and 1.1 above, all 12): the card still equals the plain
# version.  tests/test_torch_farneback_kernels.py runs the tiny kernel's
# program and tiles on the CPU at each of them.
K1_TINY_CASES = (
    [(h, w, 5, s) for h, w in ((5, 122), (5, 124), (4, 200), (7, 300), (2, 1920), (1, 200),
                               (200, 1), (1, 1), (122, 5), (1088, 5), (200, 3), (5, 5), (3, 17))
     for s in (5.0, 1.1, 0.3)]
    + [(h, w, 7, s) for h, w in ((7, 300), (3, 130), (300, 7), (1, 1)) for s in (1.5, 0.3)]
    + [(122, 5, 5, 0.3), (5, 5, 5, 1.5), (109, 4, 5, 5.0), (69, 2, 7, 1.5), (50, 5, 7, 5.0),
       (246, 2, 7, 0.3), (197, 2, 7, 1.1), (175, 6, 7, 1.1), (241, 4, 7, 0.3), (17, 3, 5, 0.3)])


def k1_narrow_phase(dev, name: str, smi: str) -> dict:
    """K1's narrow form (``ops/flow_kernels.poly_exp_narrow``: w + n < 128,
    where XLA's compiled ``poly_exp`` rounds the y^2 plane otherwise) on
    both CUDA instances: ``torch.equal`` to the plain version at the narrow
    levels of the pipelines (A's 60x60, 720p's 65x115, 4K's 59x104) and on
    both sides of the boundary, at the sigmas 5.0 and 1.1 (the compile-time
    n = 5 instance), n = 7 at 1.5 (n = 7) and sigma 0.3 (the runtime-n
    kernel) at 60x60 and across the boundary.  Then K1's tiny form
    (``ops/poly_tiny``: at most n rows or columns, two stages in one launch,
    compile-time instances for n = 5 and 7 and a runtime-n one)
    ``torch.equal`` to the plain version at :data:`K1_TINY_CASES`: shapes of
    every rule of its plan (rows, one row, one column, one pixel, w = n, and
    the shapes still on the wide rule), tall and wide ones, with the
    compile-time instances' taps and with the runtime-n kernel's (sigma
    0.3).  Then K1 at the sharded flow's 282x1920 block timed beside
    ``F.conv2d``."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    gen = torch.Generator(device=dev).manual_seed(13)
    narrow = 0
    shapes = ((60, 60), (65, 115), (59, 104), (64, 122), (64, 123), (64, 124), (100, 100),
              (128, 79), (79, 128))
    cases = [(h, w, 5, s) for h, w in shapes for s in (5.0, 1.1)]
    cases += [(h, w, 5, 0.3) for h, w in ((60, 60), (64, 122), (64, 123), (64, 124))]
    cases += [(64, 120, 7, 1.5), (64, 121, 7, 1.5), (60, 60, 7, 0.3)]
    for h, w, n, sigma in cases:
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        path = "compile-time" if fk.poly_exp_compiled(n, sigma) else "runtime-n"
        narrow += fk.poly_exp_narrow(w, n)
        check("poly_exp", f"{h}x{w} n={n} sigma={sigma} ({path}, narrow "
              f"{fk.poly_exp_narrow(w, n)})", fk.poly_exp(img, n, sigma),
              fk.poly_exp_reference(img, n, sigma))
    log(f"K1 narrow form: {len(cases)} shapes bit-equal, {narrow} of them narrow")
    for h, w, n, sigma in K1_TINY_CASES:
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        path = "compile-time taps" if fk.poly_exp_compiled(n, sigma) else "runtime-n taps"
        check("poly_exp", f"{h}x{w} n={n} sigma={sigma} (tiny form, {path})",
              fk.poly_exp(img, n, sigma), fk.poly_exp_reference(img, n, sigma))
    log(f"K1 tiny form: {len(K1_TINY_CASES)} shapes bit-equal: "
        + ", ".join(f"{h}x{w} n={n} s={s}" for h, w, n, s in K1_TINY_CASES))
    img = torch.rand((282, 1920), device=dev, generator=gen) * 255
    want = fk.poly_exp_reference(img, 5, 5.0)
    err = check("poly_exp", "282x1920 (the sharded level-0 block)", fk.poly_exp(img, 5, 5.0),
                want)
    ms, plain_ms = time_pair(lambda: fk.poly_exp_reference(img, 5, 5.0),
                             lambda: fk.poly_exp(img, 5, 5.0))
    us = kernel_us(lambda: fk.poly_exp(img, 5, 5.0), dev, "poly_exp 282x1920")
    lib_ms = library_phase("poly_exp", "282x1920", poly_exp_conv(img, 5, 5.0), want,
                           1e-3 * float(want.abs().max()), dev, name, smi)
    bound = roofline.poly_exp(282, 1920).bound_us()
    log(f"poly_exp 282x1920: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device {us_text(us)}, "
        f"bound {bound:.3f} us, F.conv2d {lib_ms:.4f} ms [{name}, {smi}]")
    return {"282x1920 sharded block": {"ms": ms, "plain_ms": plain_ms, "device_us": us,
                                       "library_ms": lib_ms, "bound_us": bound,
                                       "max_abs_err": err}}


def stream_4k_phase(dev, name: str, smi: str) -> tuple[dict, dict]:
    """Pipeline A's stream step on the 4K grid (``benchmarks/stream_4k``'s
    configuration and frames): K1-K3 at every level (2176x3840, 653x1152,
    196x346, 59x104) ``torch.equal`` to their plain versions and timed; the
    step over 2 frames on the card with the launch counts set to 0 just
    before and read just after (K1 8, K3 30, K2 10: every stream step runs
    the flow, the priming one against the zero pyramid, as the main path's
    ``PER_STEP`` counts), against the same 2 frames on the CPU (every output
    but the track table bit for bit; its ids and flags equal, its state
    within 5e-3 as from points); then the benchmark shortened in its own
    process."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import stream_4k
    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames

    t0 = time.perf_counter()
    cfg = config(stream_4k.H, stream_4k.W)
    frames = make_frames(2, stream_4k.H, stream_4k.W, seed=1, n_objects=8)
    card = [torch.as_tensor(f, device=dev) for f in frames]
    rows = level_rows(dev, name, smi, card, cfg.farneback, "4K")
    gpipe, cpipe = PipelineA(cfg, dev), PipelineA(cfg, "cpu")

    def steps(pipe, inputs):
        carry = pipe.init_stream_carry()
        for f in inputs:
            carry, out = pipe.step_stream(f, carry)
        return out

    go, launches = _counted("4K step, 2 frames", lambda: steps(gpipe, card),
                            _flow_launches(stream_4k.H, stream_4k.W, 2, 2, cfg.farneback))
    t1 = time.perf_counter()
    co = steps(cpipe, [torch.as_tensor(f) for f in frames])
    fields = [f for f in go._fields if f != "snapshot"]
    _tree_equal("4K step, card vs CPU", tuple(getattr(go, f).cpu() for f in fields),
                tuple(getattr(co, f) for f in fields))
    gs, cs = go.snapshot, co.snapshot
    _tree_equal("4K step's track table, card vs CPU",
                (gs.tid.cpu(), gs.alive.cpu(), gs.lifetime.cpu(), gs.confirmed.cpu()),
                (cs.tid, cs.alive, cs.lifetime, cs.confirmed))
    serr = max_abs((gs.state.cpu(), gs.cov.cpu()), (cs.state, cs.cov))
    log(f"4K step card vs CPU (CPU {time.perf_counter() - t1:.1f} s): every grid, label and "
        f"count equal bit for bit (cells {int(go.cell_count)}, |v| max "
        f"{float(go.magnitude.max()):.3f} m/s); track table: ids, lifetimes and flags equal, "
        f"{int(gs.alive.sum())} alive, state and covariance max_abs_err {serr:.3e} (tol 5e-3)")
    if not serr <= 5e-3 or not bool(torch.isfinite(go.raw_velocity_x).all()):
        raise AssertionError(f"4K step: track state {serr} from the CPU's, over 5e-3")
    rec = _bench_process("stream_4k", ["--frames", "3", "--reps", "1"])
    if not (rec["value"] > 0 and rec["stream_carry_mb"] > 200):
        raise AssertionError(f"stream_4k: {rec}")
    log(f"phase 19 (4K): {time.perf_counter() - t0:.1f} s")
    return launches, rows


def flow_720p_phase(dev, name: str, smi: str) -> tuple[dict, dict]:
    """The batched flow at 720p (``benchmarks/flow_batched_720p``'s frames):
    K1-K3 at every level (720x1280, 216x384, 65x115) ``torch.equal`` to
    their plain versions and timed; the 8 pairs' batched flow with the
    launch counts set to 0 just before and read just after (K1 48, K3 80, K2
    40), each pair ``torch.equal`` to its own flow, pair 0 to the CPU's; then
    the benchmark shortened (1 repetition, its EPE against the numpy model of
    cv2 over the first 2 pairs, within 0.1 px)."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import flow_batched_720p as fbm
    from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames

    t0 = time.perf_counter()
    cfg = FarnebackConfig()
    frames = make_frames(fbm.BATCH + 1, fbm.H, fbm.W, seed=3)
    card = torch.as_tensor(frames.astype(np.float32), device=dev)
    rows = level_rows(dev, name, smi, [card[0], card[1]], cfg, "720p")
    im1, im2 = card[:fbm.BATCH].contiguous(), card[1:].contiguous()
    flows, launches = _counted("720p batched flow, 8 pairs",
                               lambda: fb.farneback_flow_batched(im1, im2, cfg),
                               _flow_launches(fbm.H, fbm.W, fbm.BATCH, 2 * fbm.BATCH, cfg))
    for i in range(fbm.BATCH):
        if not torch.equal(flows[i], fb.farneback_flow(im1[i], im2[i], cfg)):
            raise AssertionError(f"720p batched flow: pair {i} differs from its own flow")
    t1 = time.perf_counter()
    if not torch.equal(flows[0].cpu(), fb.farneback_flow(im1[0].cpu(), im2[0].cpu(), cfg)):
        raise AssertionError("720p batched flow: pair 0 differs from the CPU's flow")
    log(f"720p batched flow: 8 pairs equal to their own flows, pair 0 to the CPU's "
        f"({time.perf_counter() - t1:.1f} s; the CPU's flow is within 0.1 px of cv2 on all 8: "
        f"tests/test_torch_flow_batched_720p.py)")
    rec = fbm.run(dev, reps=1, epe_pairs=2)
    log(f"benchmarks.flow_batched_720p shortened (1 rep, EPE over 2 pairs): {json.dumps(rec)}")
    if not (rec["value"] > 0 and rec["epe_within_budget"]):
        raise AssertionError(f"flow_batched_720p: {rec}")
    log(f"phase 20 (720p): {time.perf_counter() - t0:.1f} s")
    return launches, rows


def quality_phase(dev, name: str, smi: str, n_frames: int = 12) -> dict:
    """The quality benchmark's two evaluations on the easy scene over
    ``n_frames`` frames, in this process with the launch counts set to 0
    just before and read just after (K1, K3 at A's 200x200 and 60x60 levels,
    the exact warp's route: no K4 or K2, K5 under GMFA's ICP, K7 on both);
    the report's numbers finite, A's
    velocity grids within 1e-5 m/s of the numpy model of cv2 and the DBSCAN
    partitions reported as not run (no sklearn here) or compared; then
    ``benchmarks.evaluate`` in its own process."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import quality

    t0 = time.perf_counter()
    torch.cuda.synchronize(dev)
    reset_launches()
    rep = quality.run(dev, n_frames, ["easy"])
    torch.cuda.synchronize(dev)
    launches = read_launches()
    log(f"quality, easy scene, {n_frames} frames: launches {launches}")
    if any(launches[k] <= 0 for k in ("poly_exp", "fused_iteration", "level_image",
                                      "nearest_neighbors")) \
            or launches["warp_matrices"] or launches["blur_solve"]:
        raise AssertionError(f"quality: launches {launches}")
    need_rounding("quality", launches, ROUNDING)
    entry = rep["scenes"]["easy"]
    a, g = entry["optical_flow"], entry["gmfa"]
    log(f"quality report: {json.dumps(rep)}")
    oracle = a["oracle_agreement"]
    if a["pairs"] != n_frames - 1 or oracle["velocity_grid_max_abs_diff_mps"] > 1e-5:
        raise AssertionError(f"quality: pipeline A {a}")
    if oracle["dbscan_label_partitions_equal"] != "not run: no sklearn" and \
            oracle["dbscan_label_partitions_equal"] != f"{n_frames - 1}/{n_frames - 1}":
        raise AssertionError(f"quality: DBSCAN partitions {oracle}")
    if not (a["tp"] > 0 and g["frames"] == n_frames and np.isfinite(g["fps"])):
        raise AssertionError(f"quality: {entry}")
    rec = _bench_process("evaluate", ["4"])
    if rec["optical_flow"]["pairs"] != 3 or not rec["gmfa"]["fps"] > 0:
        raise AssertionError(f"evaluate: {rec}")
    log(f"phase 21 (quality): {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ the multi-rank dry run

def sharded_phase(name: str, smi: str, timeout: float = 600.0) -> tuple[dict, dict]:
    """Phase 18: ``dryrun.py`` on 4 ranks sharing this card over gloo, in a
    process group of its own (killed whole at ``timeout``).  Raises unless
    it passed every check (each kernel it ran held to its plain version
    among them), and each rank's launches of one sharded flow call are the
    code's reckoning.  Returns the launches of every rank's counted runs,
    summed, and the dry run's report."""
    from datmo_using_optical_flow_tpu_torch.dryrun import KERNELS, LEVEL
    from datmo_using_optical_flow_tpu_torch.parallel.sharded_flow import sharded_flow_launches

    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "datmo_using_optical_flow_tpu_torch.dryrun", "--ranks", "4",
           "--backend", "gloo", "--device", "cuda", "--timeout", str(timeout - 60)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"dryrun did not end within {timeout:g} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun exited {proc.returncode}:\n{err[-4000:]}")
    lines = out.strip().splitlines()
    rep = json.loads(lines[-1])
    for line in lines[:-1]:
        log(f"  {line}")
    p2 = rep["phase2"]
    want = sharded_flow_launches(*p2["shape"])
    launches: dict = {}
    for r in rep["per_rank"]:
        if r["launches"]["sharded_flow"] != want:
            raise AssertionError(f"rank {r['rank']}: one sharded flow call launched "
                                 f"{r['launches']['sharded_flow']}, the code gives {want}")
        for counts in r["launches"].values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    checks = rep.get("kernel_checks", [])
    missing = set(KERNELS) - {row["kernel"] for row in checks}
    if missing:
        raise AssertionError(f"dryrun: {sorted(missing)} not held to their plain versions")
    for row in checks:  # the dry run raised unless each equals its plain version
        timed = ""
        if "ms" in row:
            us = row["device_us"]
            timed = (f"; kernel {row['ms']:.4f} ms, device "
                     f"{'not measured' if us is None else f'{us:.1f} us'}, plain "
                     f"{row['plain_ms']:.4f} ms, bound {row['bound_us']:.3f} us "
                     f"({row['bound_by']}) [{name}, {smi}]")
        log(f"{row['kernel']} at {row['shape']} ({row['phase']}, rank 0): equal to its plain "
            f"version{timed}")
    level = rep.get("level_iterations")
    if level is None or any(level):
        raise AssertionError(f"dryrun: the sharded level on the card against the CPU's after "
                             f"each iteration: {level}")
    log(f"sharded level (4 ranks, {LEVEL[0]} rows each, {LEVEL[1]} columns) on the card "
        f"bit-equal to the CPU's after each of iterations 1-{len(level)}: values differing "
        f"{level}")
    p4 = rep["phase4"]
    log(f"sharded flow {p2['shape'][0]}x{p2['shape'][1]} over 4 ranks sharing one card over "
        f"gloo (not a four-card speed): ms per call by rank "
        f"{[round(r['sharded_ms'], 3) for r in rep['per_rank']]}, the unsharded flow "
        f"{rep['unsharded_ms']:.3f} ms in the same call; max EPE {p2['max_epe']:.3e}; "
        f"launches per rank (rank 0) {rep['per_rank'][0]['launches']['sharded_flow']}; phase 4 "
        f"velocity against the packed-warp step {p4['packed']['velocity_err']:.3e} m/s, the "
        f"exact-warp step {p4['exact']['velocity_err']:.3e} m/s [{name}, {smi}]")
    log(f"phase 18 (dry run, {rep['ranks']} ranks): {time.perf_counter() - t0:.1f} s")
    return launches, rep


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
    results["level_image"] = level_image_phase(dev, name, smi)
    other_shapes_phase(dev)
    route_rows, route_launches = exact_route_phase(dev, name, smi)
    t0 = time.perf_counter()
    narrow_rows = k1_narrow_phase(dev, name, smi)
    log(f"phase 4b (K1's narrow form): {time.perf_counter() - t0:.1f} s")
    slice_phase(dev, 256, 320)
    n_frames = 25
    launches = main_path(dev, name, smi, 1080, 1920, n_frames)
    by_path = {"stream_1080p": dict(launches)}
    want = {k: PER_STEP.get(k, 0) * n_frames for k in tpu_kernels(launches)}
    if tpu_kernels(launches) != want:
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
    for k, v in k5_launches.items():
        launches[k] += v
    t0 = time.perf_counter()
    results.update(round_phase(dev, name, smi, round_cases(round_runs(dev, gpipe, gclouds))))
    log(f"K7 phase: {time.perf_counter() - t0:.1f} s")
    diag = diagnostics_phase(dev, gcfg, (*pair[0], *pair[1]))
    by_path.update(gmfa=k5_launches, diagnostics=diag)
    launches.update({k: diag[k] for k in ("warp_matrices", "tiny")})
    with tempfile.TemporaryDirectory() as root:
        fp_launches, fp_rows = from_points_phase(dev, name, smi, root)
        gmfa_files_phase(dev, name, smi, root)
        benchmarks_phase()
        compat_launches = compat_phase(dev, name, smi, root, gclouds)
    t0 = time.perf_counter()
    icp_launches, icp_ab = icp_options_phase(dev, name, smi, pair, gcfg.icp)
    log(f"phase 16 (ICP options): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stream_launches = streams_phase(dev, name, smi, gclouds)
    log(f"phase 17 (streams): {time.perf_counter() - t0:.1f} s")
    sharded_launches, sharded = sharded_phase(name, smi)
    k4_launches, k4_rows = stream_4k_phase(dev, name, smi)
    p720_launches, p720_rows = flow_720p_phase(dev, name, smi)
    quality_launches = quality_phase(dev, name, smi)
    by_path.update(from_points=fp_launches, compat=compat_launches, icp_options=icp_launches,
                   streams=stream_launches, sharded_dryrun=sharded_launches,
                   stream_4k=k4_launches, flow_batched_720p=p720_launches,
                   quality=quality_launches, exact_route=route_launches)
    for counts in (fp_launches, compat_launches, icp_launches, stream_launches,
                   sharded_launches, k4_launches, p720_launches, quality_launches,
                   route_launches):
        for k, v in counts.items():
            launches[k] += v
    for rows in (fp_rows, {"poly_exp": narrow_rows}, k4_rows, p720_rows,
                 {"fused_iteration": route_rows}):
        for k, by_shape in rows.items():
            results[k].setdefault("levels", {}).update(by_shape)
            results[k]["max_abs_err"] = max([results[k]["max_abs_err"]]
                                            + [r["max_abs_err"] for r in by_shape.values()])

    from datmo_using_optical_flow_tpu_torch.diagnostics import roofline

    work = {"poly_exp": roofline.poly_exp(1080, 1920), "blur_solve": roofline.blur_solve(97, 173),
            "fused_iteration": roofline.fused_iteration(1080, 1920),
            "warp_matrices": roofline.warp_matrices(1080, 1920),
            "nearest_neighbors": results["nearest_neighbors"]["work"],
            "tiny": roofline.tiny(8 * 128), "fma32": results["fma32"]["work"],
            "sumsq": results["sumsq"]["work"],
            "transform_points": results["transform_points"]["work"],
            "level_image": roofline.level_images(1080, 1920, ((97, 173, 25), (324, 576, 7),
                                                              (1080, 1920, 3))),
            "warp_packed": roofline.warp_packed(97, 173),
            "corner_scale": roofline.corner_scale(97, 173)}
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
            kernels[-1]["device_ms_per_step"] = {str(c): v for c, v in k5_step_ms.items()
                                                 if c != "bound_us"}
            kernels[-1]["bound_us_per_step"] = k5_step_ms["bound_us"]
            kernels[-1]["icp_sweeps"] = {
                s: {"icp_ms": icp_ab[s]["ms"], "k5_device_ms": icp_ab[s]["k5_device_ms"],
                    "k5_bound_us": icp_ab[s]["k5_bound_us"],
                    "busiest_round_us": icp_ab[s]["busiest_round"]["k5_us"],
                    "busiest_block_us": icp_ab[s]["busiest_round"]["busiest_block_us"]}
                for s in ("compact", "inplace")}
        if k in ("poly_exp", "blur_solve", "fused_iteration", "level_image",
                 "warp_packed", "corner_scale"):  # at each level
            kernels[-1]["levels"] = res["levels"]
            kernels[-1]["sharded_flow_launches_per_rank"] = (
                sharded["per_rank"][0]["launches"]["sharded_flow"].get(k, 0))
        dry = [row for row in sharded["kernel_checks"] if row["kernel"] == k]
        if dry:  # held to its plain version at the dry run's shapes
            kernels[-1]["dryrun_checks"] = dry
        if k in ROUNDING:
            kernels[-1]["device_us"] = res["device_us"]
        if k == "sumsq":  # each call site's row; the line's numbers are tracker A's
            kernels[-1]["main_site"] = res["main_site"]
            kernels[-1]["sites"] = {
                label: {**{f: row[f] for f in ("ms", "plain_ms", "device_us", "library_ms")},
                        "bound_us": row["work"].bound_us(), "bound_by": row["work"].bound_by()}
                for label, row in res["sites"].items()}
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
