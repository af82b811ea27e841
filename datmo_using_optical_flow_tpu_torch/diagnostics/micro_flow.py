"""Micro-profile of the flow kernels at the full-size level with real flow.

The counterpart of the JAX package's ``benchmarks/micro_flow.py``.  The two
frames' pyramids and their converged flow come from the port's
``build_pyramid`` and ``flow_from_pyramids`` (the pipeline's configuration;
the number of distinct displacements matters to the warp).  At the finest
level it times K3 (one fused iteration, with the pipeline's box window and
with the Gaussian one), K4 (the standalone warp and M), K2 on K4's M and the
packed-gather ``update_matrices`` (plain PyTorch, for reference); K3 at the
second level (324x576 at 1080p) with that level's converged flow; K2 at the
coarsest level (97x173) on the packed ``update_matrices``' M with that
level's converged flow, as the step runs it; and K1 at every level, on the
image ``build_pyramid`` gives it (1080x1920, 324x576 and 97x173 at 1080p).
Each row gives ms per call, device µs, the bytes and operations of
the work, its bound on the H100 and the share of the bound reached
(``roofline``).

With ``--parent DIR``, an older checkout of the repo (``git archive <rev> |
tar -x -C build/parent``, say), that checkout's ``flow_kernels.cu`` is built
by hand beside the package's, and every K1, K2 and K3 row also holds both
builds bit-equal to the plain version and takes their device µs in turns on
the same inputs (the parent, this build twice, the parent; three times).

With ``--small``, K1 alone at the pipelines' small levels and two tiny
images instead (:func:`small_levels`): each beside one ``F.conv2d`` that
computes the same planes, per call and split into the host's enqueue and the
device's time.

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow [--height H --width W]
        [--parent DIR] [--small]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
from datmo_using_optical_flow_tpu_torch.diagnostics import roofline
from datmo_using_optical_flow_tpu_torch.diagnostics.measure import (card_label,
                                                                     device_us_per_call,
                                                                     kernel_row, ms_per_call)
from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

_WINDOW_ENTRIES = ("datmo_fused_iteration", "datmo_blur_solve")
_PARENT_ENTRIES = (*_WINDOW_ENTRIES, "datmo_poly_exp")


class Inputs(NamedTuple):
    cfg: FarnebackConfig
    gaussian: bool
    image: torch.Tensor                 # the first frame, float32
    pyr1: tuple[torch.Tensor, ...]      # (5, lh, lw) per level, coarsest first
    pyr2: tuple[torch.Tensor, ...]
    flows: list[tuple[torch.Tensor, torch.Tensor]]  # converged (dx, dy) per level


def inputs(frames: np.ndarray, dev: torch.device) -> Inputs:
    """The pipeline's own inputs of the flow kernels for the first two of
    ``frames``: both pyramids and, at each level, the converged flow of
    ``flow_from_pyramids`` over the levels up to it."""
    c = FarnebackConfig()
    gaussian = bool(c.flags & fb.OPTFLOW_FARNEBACK_GAUSSIAN)
    im1, im2 = (torch.as_tensor(np.asarray(f), device=dev).to(torch.float32) for f in frames[:2])
    pyr1, pyr2 = (fb.build_pyramid(im, c.pyr_scale, c.levels, c.poly_n, c.poly_sigma)
                  for im in (im1, im2))
    flows = []
    for n in range(1, len(pyr1) + 1):
        flow = fb.flow_from_pyramids(pyr1[:n], pyr2[:n], c.pyr_scale, c.winsize, c.iterations,
                                     True, gaussian)
        flows.append((flow[..., 0].contiguous(), flow[..., 1].contiguous()))
    return Inputs(c, gaussian, im1, pyr1, pyr2, flows)


def parent_library(parent: str | Path) -> ctypes.CDLL:
    """``flow_kernels.cu`` of the checkout at ``parent``, built by hand with
    the package's flags into ``build/parent_kernels/``, with the C signatures
    of its K1, K2 and K3 entry points set."""
    source = Path(parent) / "datmo_using_optical_flow_tpu_torch" / "csrc" / "flow_kernels.cu"
    out = build.BUILD_DIR.parent / "parent_kernels" / "libflow_kernels.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for entry in _PARENT_ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = build._SIGNATURES[entry]
    return lib


def parent_call(lib: ctypes.CDLL, args: tuple, winsize: int, gaussian: bool) -> Callable:
    """A call of the parent's K3 (four tensors ``R0, R1, dx, dy``) or K2 (one,
    ``M``) on the current stream, allocating its outputs as the wrapper does."""
    fn = getattr(lib, _WINDOW_ENTRIES[0] if len(args) == 4 else _WINDOW_ENTRIES[1])
    first = args[0]
    h, w = first.shape[-2:]
    taps, scale = fk._window(winsize, gaussian)
    ptrs = [t.data_ptr() for t in args]

    def call():
        odx = torch.empty((h, w), dtype=torch.float32, device=first.device)
        ody = torch.empty_like(odx)
        build.check(fn(odx.data_ptr(), ody.data_ptr(), *ptrs, h, w, taps.ctypes.data, winsize,
                       scale, first.device.index,
                       torch.cuda.current_stream(first.device).cuda_stream), "parent")
        return odx, ody

    return call


def parent_poly_exp(lib: ctypes.CDLL, img: torch.Tensor, n: int, sigma: float) -> Callable:
    """A call of the parent's K1 on ``img`` on the current stream, allocating
    its output as the wrapper does; returns ``(planes,)``."""
    h, w = img.shape
    taps = fk._poly_taps(n, float(sigma))
    ptr = img.data_ptr()

    def call():
        out = torch.empty((5, h, w), dtype=torch.float32, device=img.device)
        build.check(lib.datmo_poly_exp(out.data_ptr(), ptr, h, w, n,
                                       *(t.ctypes.data for t in taps), img.device.index,
                                       torch.cuda.current_stream(img.device).cuda_stream),
                    "parent")
        return (out,)

    return call


def against_parent(call: Callable, parent: Callable, plain: Callable, work: roofline.Work,
                   dev: torch.device, card: str, rounds: int = 3, reps: int = 5) -> dict:
    """Hold this build's ``call`` and the parent's to ``plain`` bit for bit,
    time ``plain`` per call, then take both device µs in turns (the parent,
    this build twice, the parent), ``rounds`` times; medians."""
    want = plain()
    plain_ms = ms_per_call(plain, dev, reps=3, warmup=1)
    for name, fn in (("this build", call), ("the parent", parent)):
        if not all(torch.equal(g, x) for g, x in zip(fn(), want)):
            raise AssertionError(f"{name} differs from the plain version")
    us = {"package": [], "parent": []}
    for _ in range(rounds):
        for name, fn in (("parent", parent), ("package", call), ("package", call),
                         ("parent", parent)):
            us[name].append(device_us_per_call(fn, dev, reps))
    med = {name: statistics.median(v) for name, v in us.items()}
    bound = work.bound_us()
    print(f"{'':44s} in turns: device {med['package']:.1f} us (share "
          f"{bound / med['package']:.3f}), parent {med['parent']:.1f} us (share "
          f"{bound / med['parent']:.3f}), both bit-equal to the plain version "
          f"({plain_ms:.3f} ms/call) [{card}]", flush=True)
    return {"plain_ms": plain_ms, "turns_device_us": us, "turns_median_us": med["package"],
            "parent_device_us": med["parent"], "parent_share_of_bound": bound / med["parent"]}


def run(frames: np.ndarray, device: str | torch.device = "cuda", reps: int = 20,
        parent: str | Path | None = None) -> dict:
    """Rows for the first two of ``frames`` ((n, H, W) uint8 BEV grids);
    ``parent`` as ``--parent``."""
    dev = resolve_device(device)
    if parent is not None and dev.type != "cuda":
        raise RuntimeError("the parent's kernels are built and timed on the card")
    card = card_label(dev)
    lib = None if parent is None else parent_library(parent)
    inp = inputs(frames, dev)
    c, gaussian, win = inp.cfg, inp.gaussian, inp.cfg.winsize
    dx, dy = inp.flows[-1]
    R0, R1 = inp.pyr1[-1], inp.pyr2[-1]
    _, h, w = R0.shape
    M = fk.warp_matrices(R0, R1, dx, dy)
    packed = fb.pack_corner_pairs(R1)
    print(f"micro_flow {h}x{w}: flow dx [{float(dx.min()):.2f}, {float(dx.max()):.2f}] "
          f"dy [{float(dy.min()):.2f}, {float(dy.max()):.2f}] [{card}]", flush=True)
    # the second level, and the coarsest level's packed M (update_matrices
    # with fast_warp's corner table, as the step runs it)
    S0, S1 = inp.pyr1[-2], inp.pyr2[-2]
    _, sh, sw = S0.shape
    C0, C1 = inp.pyr1[0], inp.pyr2[0]
    _, ch, cw = C0.shape
    Mc = fb.update_matrices(C0, C1, *inp.flows[0], fb.pack_corner_pairs(C1))

    def window_row(name: str, args: tuple, gauss: bool) -> dict:
        """A K3 row (``args`` R0, R1, dx, dy) or a K2 row (``args`` M)."""
        lh, lw = args[0].shape[-2:]
        if len(args) == 4:
            kernel, plain = fk.fused_iteration, fk.fused_iteration_reference
            work = roofline.fused_iteration(lh, lw, win)
        else:
            kernel, plain = fk.blur_solve, fk.blur_solve_reference
            work = roofline.blur_solve(lh, lw, win)
        row = kernel_row(name, lambda: kernel(*args, win, gauss), work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: kernel(*args, win, gauss),
                                      parent_call(lib, args, win, gauss),
                                      lambda: plain(*args, win, gauss), work, dev, card))
        return row

    rows = [
        window_row(f"K3 fused_iteration {h}x{w}", (R0, R1, dx, dy), gaussian),
        window_row(f"K3 fused_iteration {h}x{w}, Gaussian window", (R0, R1, dx, dy), True),
        kernel_row(f"K4 warp_matrices {h}x{w}", lambda: fk.warp_matrices(R0, R1, dx, dy),
                   roofline.warp_matrices(h, w), dev, card, reps),
        window_row(f"K2 blur_solve on K4's M {h}x{w}", (M,), gaussian),
        kernel_row(f"update_matrices packed (plain) {h}x{w}", lambda: fb.update_matrices(
            R0, R1, dx, dy, packed), roofline.update_matrices_packed(h, w), dev, card, reps),
        window_row(f"K3 fused_iteration {sh}x{sw}, second level", (S0, S1, *inp.flows[-2]),
                   gaussian),
        window_row(f"K2 blur_solve on packed M {ch}x{cw}, coarsest level", (Mc,), gaussian),
    ]
    # K1 on every level's image, finest first, as build_pyramid feeds it
    n, sigma = c.poly_n, c.poly_sigma
    for _, scale, lh, lw in level_sizes(h, w, c.pyr_scale, c.levels)[::-1]:
        img = fb.level_image(inp.image, scale, lh, lw)
        work = roofline.poly_exp(lh, lw, n, sigma)
        row = kernel_row(f"K1 poly_exp {lh}x{lw}", lambda img=img: fk.poly_exp(img, n, sigma),
                         work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda img=img: (fk.poly_exp(img, n, sigma),),
                                      parent_poly_exp(lib, img, n, sigma),
                                      lambda img=img: (fk.poly_exp_reference(img, n, sigma),),
                                      work, dev, card))
        rows.append(row)
    return {"card": card, "device": str(dev), "shape": [h, w],
            "parent": None if parent is None else str(parent), "rows": rows}


# K1's small shapes: the coarse levels of the pipelines (A's 200x200 and
# 60x60, 1080p's 97x173, 4K's 196x346 and 59x104, 720p's 216x384 and
# 65x115) and two tiny images (K1's tiny form)
SMALL_SHAPES = ((97, 173), (200, 200), (60, 60), (196, 346), (59, 104), (216, 384), (65, 115),
                (5, 122), (122, 5))


def conv_yardstick(img: torch.Tensor, n: int, sigma: float) -> Callable:
    """One ``F.conv2d`` that computes K1's planes: a (5, 1, 2n+1, 2n+1) weight
    of the outer products of g, xg and xxg scaled by the inverse-Gram
    entries, on the replicate-padded image, with cuDNN's TF32 off.  Timed
    beside K1; the port does not use it."""
    import torch.nn.functional as F

    from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import prepare_gaussian

    g, xg, xxg, ig = (np.asarray(a, np.float64) for a in prepare_gaussian(n, sigma))
    w = np.stack([np.outer(xg, g) * ig[1, 1], np.outer(g, xg) * ig[1, 1],
                  np.outer(g, g) * ig[0, 3] + np.outer(xxg, g) * ig[3, 3],
                  np.outer(g, g) * ig[0, 3] + np.outer(g, xxg) * ig[3, 3],
                  np.outer(xg, xg) * ig[5, 5]])
    weight = torch.as_tensor(w[:, None].astype(np.float32), device=img.device)
    padded = F.pad(img[None, None], (n, n, n, n), mode="replicate")

    def call():
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv2d(padded, weight)[0]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    return call


def enqueue_us(fn: Callable, dev: torch.device, calls: int = 200) -> float:
    """Host µs per call of ``fn`` issued back to back, unsynchronized (the
    launch path's cost while the card keeps up)."""
    import time

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    return (t1 - t0) * 1e6 / calls


def small_levels(device: str | torch.device = "cuda", reps: int = 20, seed: int = 0) -> dict:
    """K1 and its ``F.conv2d`` yardstick in turns at :data:`SMALL_SHAPES`
    (uniform random images from ``seed``, poly_n 5, sigma 5.0): per call (CUDA
    events around each synchronized call), the host's enqueue µs per call and
    the device µs per call (profiler), and K1's plain version per call, each
    row with the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("small_levels times the card")
    card = card_label(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, sigma = 5, 5.0
    rows = []
    for h, w in SMALL_SHAPES:
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        k1, conv = (lambda: fk.poly_exp(img, n, sigma)), conv_yardstick(img, n, sigma)
        row = {"shape": [h, w], "tiny": h <= n or w <= n,
               "bound_us": roofline.poly_exp(h, w, n, sigma).bound_us()}
        for name, fn in (("conv", conv), ("k1", k1), ("k1", k1), ("conv", conv)):
            row.setdefault(f"{name}_ms", []).append(ms_per_call(fn, dev, reps))
            row.setdefault(f"{name}_enqueue_us", []).append(enqueue_us(fn, dev))
            row.setdefault(f"{name}_device_us", []).append(device_us_per_call(fn, dev))
        for key in [k for k in row if isinstance(row[k], list) and k != "shape"]:
            row[key] = statistics.median(row[key])
        row["plain_ms"] = ms_per_call(lambda: fk.poly_exp_reference(img, n, sigma), dev, 3, 1)
        print(f"K1 {h}x{w}{' (tiny form)' if row['tiny'] else ''}: {row['k1_ms'] * 1e3:.1f} "
              f"us/call = enqueue {row['k1_enqueue_us']:.1f} us, device "
              f"{row['k1_device_us']:.1f} us; F.conv2d {row['conv_ms'] * 1e3:.1f} us/call = "
              f"enqueue {row['conv_enqueue_us']:.1f} us, device {row['conv_device_us']:.1f} us; "
              f"plain {row['plain_ms']:.3f} ms; bound {row['bound_us']:.3f} us [{card}]",
              flush=True)
        rows.append(row)
    return {"card": card, "device": str(dev), "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--parent", help="an older checkout whose flow_kernels.cu to time beside")
    ap.add_argument("--small", action="store_true", help="K1 at the small shapes beside F.conv2d")
    args = ap.parse_args()
    if args.small:
        print(json.dumps(small_levels()))
    else:
        print(json.dumps(run(make_frames(2, args.height, args.width), parent=args.parent)))


if __name__ == "__main__":
    main()
