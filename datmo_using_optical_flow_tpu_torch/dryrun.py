"""Single-card entry step and the multi-rank dry run, the counterpart of the
JAX package's ``__graft_entry__.py``.

* :func:`entry` -- one stream-mode pipeline-A step at the reference's
  production grid (200x200 BEV at 0.2 m): flow against the carried
  coefficient pyramid, velocity grids, continuity mask, DBSCAN, the EKF track
  table.
* :func:`dryrun_multichip` -- ``n`` ranks of a ``torch.distributed`` group
  (one process each, ``parallel/mesh.spawn``) run the four multi-rank paths,
  each held to the unsharded computation with the JAX dry run's checks:

  1. stream parallelism, pipeline A: one 200x200 DATMO step per feed, the
     ``n`` feeds shared over the ranks (``parallel/streams`` on each), the
     metrics summed over the group; feed 0's velocity grid to 1e-5 and its
     cell count equal to the single-feed step's;
  2. spatial parallelism: the row-sharded pyramidal flow at 1088x1920
     (``parallel/sharded_flow``: 272 rows per rank at n = 4, coarse levels
     replicated, level 0 halo-exchanged), EPE < 1e-3 against the unsharded
     flow.  On the card also: each rank's launches of one sharded flow call
     against :func:`~.parallel.sharded_flow.sharded_flow_launches`, and the
     ms per call of the sharded flow on every rank beside the unsharded
     flow's;
  3. stream parallelism, GMFA: one step per feed at 1024 points; feed 0's
     transform to 1e-5, its labels equal and its track state to 1e-4;
  4. stream x space: 2 feeds, each row-sharded over n/2 ranks; the flow
     gathered over the feed's space group, then the DATMO tail on every rank
     of it; feed 0's velocity to 5e-3, its cell count equal and its track
     state to 1e-3 against the unsharded frame-pair step with the packed
     warp (the production step, as the JAX dry run), and with the same
     tolerances against the step with the exact warp (the sharded flow's).

The launches of each path's run are counted on each rank (every count set to
0 just before it, read just after; the unsharded references outside).  On the
card, rank 0 also holds every kernel of each phase to its plain version on
the inputs that phase gives it: the first call at each input signature, in
the single-feed references of phases 1 and 3 and in one more sharded run of
phases 2 and 4 (``kernel_checks``: K1-K3 and K8 ``torch.equal`` and timed,
K5 and K7 bit for bit).

    python -m datmo_using_optical_flow_tpu_torch.dryrun --ranks 4 \
        [--backend gloo|nccl] [--device cuda|cpu] [--flow 1088x1920] \
        [--grid 200x200] [--points 1024] [--reps 5]

runs :func:`entry` once, then the dry run, and prints the report as one JSON
line.  ``--backend gloo --device cuda`` puts every rank on one card (the
exchange goes through host memory); ``nccl`` puts rank r on ``cuda:r``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from unittest import mock

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig,
                                                       GMFAConfig, PipelineAConfig)
from datmo_using_optical_flow_tpu_torch.diagnostics import measure, roofline
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import (PipelineA,
                                                                          _datmo_tail,
                                                                          _stream_step_impl)
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import (flow_kernels, level_kernels, nn_kernels,
                                                    round_kernels)
from datmo_using_optical_flow_tpu_torch.parallel import mesh, streams
from datmo_using_optical_flow_tpu_torch.parallel.mesh import RowGroup, shard_rows
from datmo_using_optical_flow_tpu_torch.parallel.sharded_flow import (coarse_flow,
                                                                     level0_image,
                                                                     sharded_farneback_flow,
                                                                     sharded_farneback_level,
                                                                     sharded_flow_launches,
                                                                     sharded_poly_exp)
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils import prng
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

GRID = (200, 200)     # the reference's production grid (Optical_flow/config.yaml:3-5)
FLOW = (1088, 1920)   # the sharded flow's frame
POINTS = 1024         # GMFA points per feed
# the sharded flow's options: sharded_farneback_flow's defaults
POLY_N, POLY_SIGMA, WINSIZE, WARP_HALO = 5, 5.0, 15, 16
LEVEL = (64, 320)     # rows per rank and columns of the sharded level held to the CPU's
LEVEL_ITERATIONS = 3
_COUNTED = (flow_kernels, level_kernels, nn_kernels, round_kernels)
# the kernels the dry run launches on the card (K1-K4, K8 and K9 (its warp
# and its scale pass) in the flows,
# K5 in GMFA's step, K7 in both pipelines: ICP's transform in GMFA's), each
# held to its plain version by rank 0
KERNELS = ("poly_exp", "blur_solve", "fused_iteration", "warp_matrices", "warp_packed",
           "corner_scale", "level_image", "nearest_neighbors", "fma32", "sumsq",
           "transform_points")


def prod_cfg(h: int = GRID[0], w: int = GRID[1]) -> PipelineAConfig:
    """Pipeline A at the production shape (an (h, w) grid at 0.2 m) with the
    JAX dry run's capacities."""
    caps = CapacityConfig(max_raw_points=4096, max_roi_points=1024, max_cells=2048,
                          max_clusters=16, max_tracks=32)
    cfg = PipelineAConfig(x_range=(-0.1 * h, 0.1 * h), y_range=(-0.1 * w, 0.1 * w),
                          capacities=caps)
    if cfg.grid_shape != (h, w):
        raise ValueError(f"grid {h}x{w} gives {cfg.grid_shape}")
    return cfg


def entry(device: str | torch.device = "cuda"):
    """``(fn, example_args)``: the stream-mode DATMO step at the production
    grid on ``device`` and a random BEV with a fresh carry."""
    cfg = prod_cfg()
    dev = resolve_device(device)
    h, w = cfg.grid_shape
    rng = np.random.default_rng(0)
    bev = torch.as_tensor(rng.integers(0, 255, size=(h, w)).astype(np.uint8), device=dev)
    carry = PipelineA(cfg, dev).init_stream_carry()

    def fn(b, c):
        return _stream_step_impl(b, c, cfg, fast_warp=True)

    return fn, (bev, carry)


def textured_pair(h: int, w: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Two float32 (h, w) frames of a smooth, everywhere-textured field, the
    second shifted by ~(3, 2) px (flat patches would make the 2x2 solves
    degenerate and amplify float noise into EPE)."""
    base = rng.uniform(40, 215, size=(h // 8 + 5, w // 8 + 5))
    ys = np.linspace(0, base.shape[0] - 1.001, h + 16)
    xs = np.linspace(0, base.shape[1] - 1.001, w + 16)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    up = ((base[y0][:, x0] * (1 - fx) + base[y0][:, x0 + 1] * fx) * (1 - fy)
          + (base[y0 + 1][:, x0] * (1 - fx) + base[y0 + 1][:, x0 + 1] * fx) * fy)
    return up[8:8 + h, 8:8 + w].astype(np.float32), up[6:6 + h, 5:5 + w].astype(np.float32)


def gmfa_case(n: int, p: int, rng: np.random.Generator):
    """GMFA's configuration and per-feed clouds: a static background and a
    128-point cluster that moved 1.5 m between the frames."""
    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=20),
                     capacities=CapacityConfig(max_raw_points=p, max_roi_points=p // 8,
                                               expansion_factor=8, max_clusters=8,
                                               max_tracks=16))
    nbg = p - 128
    prev = np.empty((n, p, 3), np.float32)
    cur = np.empty((n, p, 3), np.float32)
    for s in range(n):
        bg = rng.uniform([-15, -15, 0.0], [15, 4.0, 1.5], size=(nbg, 3))
        c0 = np.array([-5.0 + s, -8.0 + 0.5 * s, 0.75])
        blob = rng.normal(scale=0.35, size=(128, 3)) + c0
        prev[s] = np.concatenate([bg, blob])
        cur[s] = np.concatenate([bg + rng.normal(scale=0.004, size=(nbg, 3)),
                                 blob + np.array([1.5, 0.4, 0.0])])
    return cfg, prev, cur


def _reset() -> None:
    for mod in _COUNTED:
        mod.reset_launches()


def _read() -> dict:
    out = {}
    for mod in _COUNTED:
        out.update(mod.LAUNCHES)
    return {k: v for k, v in out.items() if v}


def _counted(fn, dev: torch.device):
    """``fn()`` and the kernel launches it made, counted alone."""
    measure.sync(dev)
    _reset()
    out = fn()
    measure.sync(dev)
    return out, _read()


def _need(label: str, counts: dict, kernels: tuple[str, ...], dev: torch.device) -> None:
    """On the card, raise unless each of ``kernels`` launched; on the CPU,
    unless nothing did (the plain versions run there)."""
    if dev.type == "cuda":
        missing = [k for k in kernels if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} not launched (launches {counts})")
    elif counts:
        raise AssertionError(f"{label}: kernel launches {counts} on the CPU")


def _close(label: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    err = float(torch.max(torch.abs(got.double() - want.double())))
    if not err <= atol:
        raise AssertionError(f"{label}: max abs difference {err} > {atol}")
    return err


def _equal(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{label}: {got} != {want}")


def _host_ms(fn, group: RowGroup, reps: int) -> float:
    """Median host ms of one synchronized call of ``fn`` on every rank at
    once (a barrier before each call)."""
    times = []
    for _ in range(reps):
        group.barrier()
        measure.sync(group.device)
        t0 = time.perf_counter()
        fn()
        measure.sync(group.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kernel_row(name: str, kernel, plain, work: roofline.Work, shape: tuple,
                dev: torch.device) -> dict:
    """A kernel held ``torch.equal`` to its plain version on one input and
    timed beside it: ms per call (CUDA events), device µs (profiler), bound."""
    got, want = kernel(), plain()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{name} at {shape}: the kernel differs from its plain version")
    try:
        device_us = measure.device_us_per_call(kernel, dev)
    except measure.LostTrace:  # a timing, not a check: reported as not measured
        device_us = None
    return {"shape": list(shape), "max_abs_err": 0.0,
            "ms": measure.ms_per_call(kernel, dev, reps=20),
            "plain_ms": measure.ms_per_call(plain, dev, reps=10),
            "device_us": device_us, "bound_us": work.bound_us(), "bound_by": work.bound_by()}


def _sig(x) -> tuple | str:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else "number"


def _flow_sig(flow_scale) -> tuple | str:
    """The form of a warp's flow: no scale, a number or a plane."""
    return "none" if flow_scale is None else _sig(flow_scale)


@contextlib.contextmanager
def _held_to_plain(rows: dict, phase: str, dev: torch.device, on: bool = True):
    """Within, on the card and when ``on``: the first call of each kernel
    wrapper at each input signature is also held to its plain version on the
    same inputs, raising unless equal (K1-K4, K9 and K8's five wrappers
    ``torch.equal`` and timed by :func:`_kernel_row`; K5's five outputs
    ``torch.equal``; K7 bit for bit, the sum of squares in both its forms,
    of ``a`` and of ``a - b``), and its row goes to ``rows``.  The
    checks' launches are made outside the counted runs."""
    if not on or dev.type != "cuda":
        yield
        return
    fk, k5, k8, rk = flow_kernels, nn_kernels, level_kernels, round_kernels
    orig = {"poly_exp": fk.poly_exp, "blur_solve": fk.blur_solve,
            "fused_iteration": fk.fused_iteration, "warp_matrices": fk.warp_matrices,
            "warp_packed": fk.warp_matrices_packed, "corner_scale": fk.corner_scale,
            "nearest_neighbors": k5.nearest_neighbors,
            "fma32": rk._fma32, "sumsq": rk._sumsq, "transform_points": rk._transform_points,
            "level_images": k8.level_images,
            "level_image": k8.level_image, "blur": k8.blur, "resize": k8.resize,
            "upsample": k8.upsample}

    def once(key: tuple, check) -> None:
        if key not in rows:
            rows[key] = {"kernel": key[0], "phase": phase, **check()}

    def exact(name: str, ok: bool, shape) -> dict:
        if not ok:
            raise AssertionError(f"{name} at {shape}: the kernel differs from its plain version")
        return {"shape": shape, "max_abs_err": 0.0}

    def poly_exp(img, n, sigma):
        shape = tuple(img.shape)
        once(("poly_exp", shape), lambda: _kernel_row(
            "poly_exp", lambda: orig["poly_exp"](img, n, sigma),
            lambda: fk.poly_exp_reference(img, n, sigma), roofline.poly_exp(*shape, n, sigma),
            shape, dev))
        return orig["poly_exp"](img, n, sigma)

    def blur_solve(M, winsize, gaussian=False, terms=False):
        shape = tuple(M.shape)
        once(("blur_solve", shape, winsize, gaussian, terms), lambda: _kernel_row(
            "blur_solve", lambda: orig["blur_solve"](M, winsize, gaussian, terms),
            lambda: fk.blur_solve_reference(M, winsize, gaussian, terms),
            roofline.blur_solve(*shape[1:], winsize), shape, dev))
        return orig["blur_solve"](M, winsize, gaussian, terms)

    def fused_iteration(R0, R1, dx, dy, winsize, gaussian=False, flow_scale=None, terms=False):
        shape = tuple(R0.shape)
        planes = (2 if flow_scale is None or not isinstance(flow_scale, torch.Tensor) else 3,
                  3 if terms else 2)
        args = (R0, R1, dx, dy, winsize, gaussian, flow_scale, terms)
        once(("fused_iteration", shape, winsize, gaussian, _flow_sig(flow_scale), terms),
             lambda: _kernel_row(
                 "fused_iteration", lambda: orig["fused_iteration"](*args),
                 lambda: fk.fused_iteration_reference(*args),
                 roofline.fused_iteration(*shape[1:], winsize, *planes), shape, dev))
        return orig["fused_iteration"](*args)

    def warp_matrices(R0, R1, dx, dy, flow_scale=None, rows=None):
        shape = tuple(R0.shape)
        args = (R0, R1, dx, dy, flow_scale, rows)
        once(("warp_matrices", shape, _flow_sig(flow_scale), rows), lambda: _kernel_row(
            "warp_matrices", lambda: orig["warp_matrices"](*args),
            lambda: fk.warp_matrices_reference(*args), roofline.warp_matrices(*shape[1:]),
            shape, dev))
        return orig["warp_matrices"](*args)

    def corner_scale(R1):
        shape = tuple(R1.shape)
        once(("corner_scale", shape), lambda: _kernel_row(
            "corner_scale", lambda: orig["corner_scale"](R1),
            lambda: fk.corner_scale_reference(R1), roofline.corner_scale(*shape[1:]), shape,
            dev))
        return orig["corner_scale"](R1)

    def warp_matrices_packed(R0, R1, scale, dx, dy, flow_scale=None):
        shape = tuple(R0.shape)
        args = (R0, R1, scale, dx, dy, flow_scale)
        once(("warp_packed", shape, _flow_sig(flow_scale)), lambda: _kernel_row(
            "warp_packed", lambda: orig["warp_packed"](*args),
            lambda: fk.warp_packed_reference(*args), roofline.warp_packed(*shape[1:]),
            shape, dev))
        return orig["warp_packed"](*args)

    def level_images(im, levels):
        levels = tuple(tuple(lv) for lv in levels)
        taps = [len(k8._taps(*fb.level_blur(s))[1]) for s, _, _ in levels]
        once(("level_image", "levels", tuple(im.shape), levels), lambda: _kernel_row(
            "level_image", lambda: orig["level_images"](im, levels),
            lambda: fb.level_images_reference(im, levels),
            roofline.level_images(*im.shape, [(lh, lw, n) for (_, lh, lw), n in
                                              zip(levels, taps)]), tuple(im.shape), dev))
        return orig["level_images"](im, levels)

    def upsample(dx, dy, lh, lw, scale=1.0):
        shape = (*dx.shape, lh, lw)
        once(("level_image", "upsample", shape, scale), lambda: _kernel_row(
            "level_image", lambda: orig["upsample"](dx, dy, lh, lw, scale),
            lambda: tuple(fb.resize_bilinear_reference(torch.stack([dx, dy]), lh, lw, scale)),
            roofline.resize(2, *dx.shape, lh, lw, scale != 1.0), shape, dev))
        return orig["upsample"](dx, dy, lh, lw, scale)

    def level_image(im, scale, lh, lw):
        shape = (*im.shape, lh, lw)
        once(("level_image", shape), lambda: _kernel_row(
            "level_image", lambda: orig["level_image"](im, scale, lh, lw),
            lambda: fb.level_image_reference(im, scale, lh, lw),
            roofline.level_image(*shape, len(k8._taps(*fb.level_blur(scale))[1])), shape, dev))
        return orig["level_image"](im, scale, lh, lw)

    def blur(img, ksize, sigma):
        shape = (*img.shape, ksize)
        once(("level_image", "blur", shape), lambda: _kernel_row(
            "level_image", lambda: orig["blur"](img, ksize, sigma),
            lambda: fb.gaussian_blur_reference(img, ksize, sigma),
            roofline.level_image(*img.shape, *img.shape, len(k8._taps(ksize, sigma)[1])),
            shape, dev))
        return orig["blur"](img, ksize, sigma)

    def resize(img, out_h, out_w, scale=1.0):
        shape = (*img.shape, out_h, out_w)
        once(("level_image", "resize", shape, scale), lambda: _kernel_row(
            "level_image", lambda: orig["resize"](img, out_h, out_w, scale),
            lambda: fb.resize_bilinear_reference(img, out_h, out_w, scale),
            roofline.resize(img.numel() // (img.shape[-2] * img.shape[-1]), *img.shape[-2:],
                            out_h, out_w, scale != 1.0), shape, dev))
        return orig["resize"](img, out_h, out_w, scale)

    def nearest_neighbors(src, index, n_active=None, cap2=None, block_counts=None,
                          block_table=None, drift=None):
        args = (n_active, cap2, block_counts, block_table, drift)
        got = orig["nearest_neighbors"](src, index, *args)
        key = ("nearest_neighbors", tuple(src.shape), tuple(a is not None for a in args))
        once(key, lambda: exact("nearest_neighbors", all(
            torch.equal(g, w) for g, w in zip(got, k5.nearest_neighbors_reference(
                src, index, *args))), list(src.shape)))
        return got

    def fma32(a, b, c, root):
        got = orig["fma32"](a, b, c, root)
        once(("fma32", _sig(a), _sig(b), _sig(c), root), lambda: exact(
            "fma32", rk.bits_equal(got, rk.fma32_reference(a, b, c, root)),
            [_sig(a), _sig(b), _sig(c)]))
        return got

    def transform_points(points, transformation):
        got = orig["transform_points"](points, transformation)
        once(("transform_points", tuple(points.shape)), lambda: exact(
            "transform_points", rk.bits_equal(got, rk.transform_points_reference(
                points, transformation)), list(points.shape)))
        return got

    def sumsq(a, b, root):
        got = orig["sumsq"](a, b, root)
        shapes = [list(a.shape), None if b is None else list(b.shape)]
        once(("sumsq", tuple(a.shape), None if b is None else tuple(b.shape), root),
             lambda: exact("sumsq", rk.bits_equal(got, rk.sumsq_reference(a, root) if b is None
                                                  else rk.sumsq_diff_reference(a, b, root)),
                           shapes))
        return got

    with contextlib.ExitStack() as stack:
        for mod, name, fn in ((fk, "poly_exp", poly_exp), (fk, "blur_solve", blur_solve),
                              (fk, "fused_iteration", fused_iteration),
                              (fk, "warp_matrices", warp_matrices),
                              (fk, "warp_matrices_packed", warp_matrices_packed),
                              (fk, "corner_scale", corner_scale),
                              (k5, "nearest_neighbors", nearest_neighbors),
                              (k8, "level_images", level_images),
                              (k8, "level_image", level_image), (k8, "blur", blur),
                              (k8, "resize", resize), (k8, "upsample", upsample),
                              (rk, "_fma32", fma32), (rk, "_sumsq", sumsq),
                              (rk, "_transform_points", transform_points)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def _level_iterations(group: RowGroup) -> list:
    """The sharded flow's level 0 (``LEVEL`` rows per rank and columns, from
    the coarse levels' flow) run on this rank's device and on the CPU over
    the same gloo group, after each of 1 to ``LEVEL_ITERATIONS`` iterations:
    the number of flow values of the whole grid that differ at each (every
    rank's count summed).  Raises unless every count is 0."""
    cpu = RowGroup(group.rank, group.world_size, group.backend, torch.device("cpu"), group.pg,
                   group.ranks)
    h, w = LEVEL[0] * group.world_size, LEVEL[1]
    pair = textured_pair(h, w, np.random.default_rng(2))
    blocks = [shard_rows(torch.from_numpy(a), group) for a in pair]
    counts = []
    for it in range(1, LEVEL_ITERATIONS + 1):
        flows = []
        for g in (group, cpu):
            b1, b2 = (b.to(g.device) for b in blocks)
            dx, dy = coarse_flow(b1, b2, g)
            R0, R1 = (sharded_poly_exp(level0_image(b, g), POLY_N, POLY_SIGMA, g)
                      for b in (b1, b2))
            flows.append(torch.stack(sharded_farneback_level(R0, R1, dx, dy, WINSIZE, it, g, h,
                                                             WARP_HALO)).cpu())
        differ = (flows[0].view(torch.int32) != flows[1].view(torch.int32)).sum()
        counts.append(int(group.all_reduce_sum(differ.to(group.device))))
    if any(counts):
        raise AssertionError(f"the sharded level on {group.device} parts from the CPU's: "
                             f"{counts} values differ after 1..{LEVEL_ITERATIONS} iterations")
    return counts


def _dryrun_rank(group: RowGroup, grid: tuple, flow_hw: tuple, points: int,
                 reps: int) -> dict:
    """One rank of :func:`dryrun_multichip`.  Rank 0 returns the checks'
    numbers; every rank its launches per path and its sharded flow's ms."""
    dev, n = group.device, group.world_size
    cfg = prod_cfg(*grid)
    h, w = cfg.grid_shape
    rng = np.random.default_rng(0)
    out: dict = {"rank": group.rank, "device": str(dev), "launches": {}}

    # phase 1: pipeline A's frame-pair step, the feeds shared over the ranks
    bev1 = torch.as_tensor(rng.integers(0, 255, size=(n, h, w)).astype(np.uint8))
    bev2 = torch.as_tensor(rng.integers(0, 255, size=(n, h, w)).astype(np.uint8))
    feeds = mesh.stream_mesh(group, n)
    mine = slice(feeds.start, feeds.stop)
    step = streams.make_multi_stream_step(cfg, fast_warp=True, device=dev)
    (_, outs, metrics), out["launches"]["stream_a"] = _counted(
        lambda: step(bev1[mine].to(dev), bev2[mine].to(dev),
                     streams.init_stream_carry(cfg, len(feeds), dev)), dev)
    _need("phase 1", out["launches"]["stream_a"], ("poly_exp", "blur_solve", "warp_packed",
                                                   "corner_scale", "level_image"), dev)
    tracks = int(group.all_reduce_sum(metrics["total_tracks"]))
    cells = int(group.all_reduce_sum(metrics["total_cells"]))
    checks: dict = {}  # rank 0's kernels held to their plain versions, by signature
    if feeds.start == 0:
        pipe = PipelineA(cfg, dev, fast_warp=True)
        with _held_to_plain(checks, "phase 1", dev):
            _, ref = pipe.step(bev1[0].to(dev), bev2[0].to(dev), pipe.init_carry())
        out["phase1"] = {
            "grid": [h, w], "total_tracks": tracks, "total_cells": cells,
            "velocity_err": _close("phase 1 velocity_x", outs.velocity_x[0],
                                   ref.velocity_x, 1e-5)}
        _equal("phase 1 cell count", outs.cell_count[0], ref.cell_count)

    # phase 2: the row-sharded flow against the unsharded flow
    hh, ww = flow_hw
    img1, img2 = (torch.from_numpy(a) for a in textured_pair(hh, ww, rng))
    b1, b2 = shard_rows(img1, group), shard_rows(img2, group)
    flow_loc, counts = _counted(lambda: sharded_farneback_flow(b1, b2, group), dev)
    want = sharded_flow_launches(hh, ww) if dev.type == "cuda" else {}
    out["launches"]["sharded_flow"] = counts
    if counts != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"rank {group.rank}: one sharded flow call launched {counts}, "
                             f"the code gives {want}")
    got = group.all_gather_rows(flow_loc)
    unsharded = (lambda: fb._farneback_impl(img1.to(dev), img2.to(dev), 0.3, 5, WINSIZE, 5,
                                            POLY_N, POLY_SIGMA, fast_warp=False))
    if group.rank == 0:
        epe = float(torch.linalg.vector_norm(got - unsharded(), dim=-1).max())
        if not epe < 1e-3:
            raise AssertionError(f"sharded flow vs unsharded: EPE {epe}")
        out["phase2"] = {"shape": [hh, ww], "rows_per_rank": hh // n, "max_epe": epe}
    with _held_to_plain(checks, "phase 2", dev, group.rank == 0):
        sharded_farneback_flow(b1, b2, group)
    if reps:
        out["sharded_ms"] = _host_ms(lambda: sharded_farneback_flow(b1, b2, group), group, reps)
        group.barrier()
        if group.rank == 0:
            out["unsharded_ms"] = measure.ms_per_call(unsharded, dev, reps=reps, warmup=1)
        group.barrier()

    # the sharded level on the card against the CPU's after each iteration
    if group.backend == "gloo":
        out["level_iterations"] = _level_iterations(group)

    # phase 3: GMFA's step, the feeds shared over the ranks
    gcfg, prev, cur = gmfa_case(n, points, rng)
    max_moving = points // 2
    prev, cur = torch.from_numpy(prev).to(dev), torch.from_numpy(cur).to(dev)
    gmask = torch.ones((n, points), dtype=torch.bool, device=dev)
    keys = torch.stack([prng.PRNGKey(100 + s) for s in range(n)])
    gstep = streams.make_multi_stream_gmfa_step(gcfg, max_moving, dev)
    gcarry = streams.seed_gmfa_stream_carry(
        streams.init_gmfa_stream_carry(gcfg, len(feeds), dev), prev[mine], gmask[mine])
    (gcarry2, gouts, gm), out["launches"]["stream_gmfa"] = _counted(
        lambda: gstep(cur[mine], gmask[mine], gcarry, keys[mine]), dev)
    _need("phase 3", out["launches"]["stream_gmfa"],
          ("nearest_neighbors", "transform_points", "sumsq"), dev)
    if bool(gouts.skip.any()):
        raise AssertionError("phase 3: a GMFA feed skipped its step")
    moving = int(group.all_reduce_sum(gm["total_moving"]))
    gtracks = int(group.all_reduce_sum(gm["total_tracks"]))
    if feeds.start == 0:
        gpipe = GMFAPipeline(gcfg, max_moving, dev)
        with _held_to_plain(checks, "phase 3", dev):
            c1, o1 = gpipe.step(cur[0], gmask[0], gpipe.seed_carry(prev[0], gmask[0]), keys[0])
        out["phase3"] = {
            "points": points, "total_moving": moving, "total_tracks": gtracks,
            "transform_err": _close("phase 3 transformation", gouts.transformation[0],
                                    o1.transformation, 1e-5),
            "state_err": _close("phase 3 track state", gcarry2.table.state[0],
                                c1.table.state, 1e-4)}
        _equal("phase 3 labels", gouts.labels[0], o1.labels)

    # phase 4: 2 feeds x n/2 row ranks; the flow gathered, the tail per rank
    feeds4, space = mesh.stream_space_mesh(group, 2, n // 2)
    scenes = [make_frames(2, h, w, seed=20 + s, n_objects=3) for s in range(2)]
    pipe = PipelineA(cfg, dev, fast_warp=True)

    def combined(s):
        a1, a2 = (shard_rows(torch.from_numpy(scenes[s][t]), space) for t in (0, 1))
        flow = space.all_gather_rows(sharded_farneback_flow(a1.to(torch.float32),
                                                            a2.to(torch.float32), space))
        valid = [space.all_reduce_sum(torch.any(a > 0).to(torch.int32)) > 0 for a in (a1, a2)]
        return _datmo_tail(flow, valid[0] & valid[1], pipe.init_carry(), cfg)

    results, out["launches"]["stream_space"] = _counted(
        lambda: [combined(s) for s in feeds4], dev)
    _need("phase 4", out["launches"]["stream_space"], ("poly_exp", "blur_solve", "warp_matrices",
                                                       "level_image"),
          dev)
    with _held_to_plain(checks, "phase 4", dev, feeds4.start == 0 and space.rank == 0):
        for s in feeds4:
            combined(s)
    if feeds4.start == 0 and space.rank == 0:
        carry4, out4 = results[0]
        pair = [torch.from_numpy(scenes[0][t]).to(dev) for t in (0, 1)]
        out["phase4"] = {"streams": 2, "space_ranks": n // 2, "cells": int(out4.cell_count)}
        for warp, ref_pipe in (("packed", pipe), ("exact", PipelineA(cfg, dev, fast_warp=False))):
            refc, ref = ref_pipe.step(*pair, ref_pipe.init_carry())
            out["phase4"][warp] = {
                "velocity_err": _close(f"phase 4 velocity_x ({warp} warp)", out4.velocity_x,
                                       ref.velocity_x, 5e-3),
                "state_err": _close(f"phase 4 track state ({warp} warp)", carry4.table.state,
                                    refc.table.state, 1e-3)}
            _equal(f"phase 4 cell count ({warp} warp)", out4.cell_count, ref.cell_count)
    if checks:
        missing = set(KERNELS) - {row["kernel"] for row in checks.values()}
        if missing:
            raise AssertionError(f"{sorted(missing)}: run by the dry run on the card but not "
                                 f"held to their plain versions")
        out["kernel_checks"] = list(checks.values())
    group.barrier()
    return out


def dryrun_multichip(n: int, backend: str = "gloo", device: str = "cuda",
                     grid: tuple = GRID, flow_hw: tuple = FLOW, points: int = POINTS,
                     reps: int = 5, timeout: float = 900.0) -> dict:
    """The four multi-rank paths on ``n`` ranks, each held to the unsharded
    computation (module docstring); raises on the first failed check.

    ``backend``/``device``: ``"gloo"`` with ``"cpu"`` (every rank on the
    CPU), ``"gloo"`` with a CUDA device (every rank on that card, the
    exchange through host memory), or ``"nccl"`` with ``"cuda"`` (rank r on
    ``cuda:r``).  ``grid``, ``flow_hw`` and ``points`` size phases 1 and 4,
    phase 2 and phase 3; ``reps`` timed calls of the sharded flow per rank
    (0: none).  Returns rank 0's report with every rank's launches and ms
    under ``"ranks"``."""
    if n < 2 or n % 2:
        raise ValueError(f"the dry run needs an even number of ranks, got {n}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"ranks on the CPU need gloo, got {backend!r}")
        devices = ["cpu"] * n
    else:
        resolve_device(dev)
        if backend == "nccl":
            if torch.cuda.device_count() < n:
                raise RuntimeError(f"nccl needs a card per rank: {n} ranks, "
                                   f"{torch.cuda.device_count()} cards")
            devices = [f"cuda:{r}" for r in range(n)]
        else:
            devices = [f"cuda:{dev.index or 0}"] * n
    t0 = time.perf_counter()
    ranks = mesh.spawn(_dryrun_rank, n, backend, devices, tuple(grid), tuple(flow_hw),
                       points, reps, timeout=timeout)
    report = {k: v for k, v in ranks[0].items() if k not in ("rank", "launches", "sharded_ms")}
    report.update(ranks=n, backend=backend, devices=devices,
                  seconds=time.perf_counter() - t0,
                  per_rank=[{k: r[k] for k in ("rank", "launches", "sharded_ms") if k in r}
                            for r in ranks])
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=mesh.BACKENDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", default="x".join(map(str, GRID)), help="HxW of phases 1 and 4")
    ap.add_argument("--flow", default="x".join(map(str, FLOW)), help="HxW of phase 2")
    ap.add_argument("--points", type=int, default=POINTS, help="GMFA points per feed")
    ap.add_argument("--reps", type=int, default=5, help="timed sharded flow calls per rank")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    size = lambda s: tuple(int(v) for v in s.split("x"))  # noqa: E731

    fn, example = entry(args.device)
    _, outputs = fn(*example)
    print(f"entry() ran on {args.device}: cell_count {int(outputs.cell_count)}, "
          f"skip {bool(outputs.skip)}", flush=True)
    report = dryrun_multichip(args.ranks, args.backend, args.device, size(args.grid),
                              size(args.flow), args.points, args.reps, args.timeout)
    p1, p2, p3, p4 = (report[f"phase{i}"] for i in (1, 2, 3, 4))
    print(f"dryrun_multichip({args.ranks}, {args.backend}, {args.device}): stream-parallel "
          f"DATMO step ok at {p1['grid'][0]}x{p1['grid'][1]} (tracks={p1['total_tracks']}, "
          f"cells={p1['total_cells']}); row-sharded flow ok at {p2['shape'][0]}x"
          f"{p2['shape'][1]}/{args.ranks} ranks (max EPE vs unsharded {p2['max_epe']:.2e}); "
          f"stream-parallel GMFA step ok at {p3['points']}x{args.ranks} points (tracks="
          f"{p3['total_tracks']}, moving={p3['total_moving']}); {p4['streams']} streams x "
          f"{p4['space_ranks']} row ranks pipeline-A step ok (cells={p4['cells']}); "
          f"{report['seconds']:.1f} s", flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
