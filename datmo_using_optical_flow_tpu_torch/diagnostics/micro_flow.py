"""Micro-profile of the flow kernels at the full-size level with real flow.

The counterpart of the JAX package's ``benchmarks/micro_flow.py``.  The two
frames' pyramids and their converged flow come from the port's
``build_pyramid`` and ``flow_from_pyramids`` (the pipeline's configuration;
the number of distinct displacements matters to the warp).  At the finest
level it times K3 (one fused iteration, with the pipeline's box window and
with the Gaussian one, and as the step runs it between iterations, the flow
in and out as numerators and 1 / det), K4 (the standalone warp and M), K2
on K4's M and K9 (the packed warp); K3 at the second level (324x576
at 1080p) with that level's converged flow; K2 at the coarsest level
(97x173) on K9's M with that level's converged flow, as the step runs it,
and K9 there; and K1 at every level, on the
image ``build_pyramid`` gives it (1080x1920, 324x576 and 97x173 at 1080p).
Each row gives ms per call, device µs, the bytes and operations of
the work, its bound on the H100 and the share of the bound reached
(``roofline``).

With ``--parent DIR``, an older checkout of the repo (``git archive <rev> |
tar -x -C build/parent``, say), that checkout's ``flow_kernels.cu`` is built
by hand beside the package's, and every K1-K4 row also holds this
build bit-equal to the plain version, gives the parent's largest difference
from it (0 unless the parent rounds otherwise) and takes both builds' device
µs in turns on the same inputs (the parent, this build twice, the parent;
three times).  A parent's entry points are called with the C signature its
source declares.

With ``--tiny``, also K4 and K2 (Gaussian window) at tiny levels (4x4,
2x64) and K1's tiny form at 5x5, 122x5, 300x7 (poly_n 7) and 2x1920
(:func:`tiny_rows`), with the parent in turns where given and K1 beside its
``F.conv2d`` yardstick in turns; K9's row is timed against the parent too.

With ``--small``, K1 alone at the pipelines' small levels and two tiny
images instead (:func:`small_levels`): each beside one ``F.conv2d`` that
computes the same planes, per call and split into the host's enqueue and the
device's time.

With ``--k8``, K8 instead (:func:`k8_rows`): a frame's level images in one
launch, each level alone and the flow's 2-plane upsamples, at the 1080p,
from-points, 4K and 720p flows' shapes, each with its bound; with
``--parent``, that checkout's ``level_kernels.cu`` is built by hand too, and
its calls, made as its wrapper made them (one call per level image, the
upsample of a stacked flow), are held beside this build's in turns, per call
and by device µs; the upsample's host path is split into its parts for both
(:func:`upsample_path`).

With ``--k7``, K7's sum of squares of a difference instead (:func:`k7_rows`)
at the main paths' sites, beside one PyTorch call of each (:func:`sumsq_library`)
and, with ``--parent``, that checkout's ``round_kernels.cu`` built by hand and
called as its wrapper called it, in turns; then the launch path's host parts
at tracker A's site (:func:`sumsq_path`); then K7's fma at GMFA's sites at
reference load, ICP's former broadcast call and A's 1080x1920 magnitude, with
their launches per preprocess and per step, beside ``torch.addcmul`` and, with
``--parent``, that checkout's fma called as its wrapper called it, in turns;
and ICP's ``transform_points`` at 102,400 points, one launch, beside the
parent's (four calls before it had the kernel) and ``torch.addmm``
(:func:`gmfa_fma32_rows`).

With ``--k9``, K9 alone instead (:func:`k9_rows`) at the pipelines' small
levels and 1080x1920: its scale pass beside ``torch.amax``, the warp through
its wrapper, and a level's whole packed warp (the scale pass and 5 warps) by
device records; with ``--parent``, that checkout's K9 in turns, alone and for
the level (over its ``pack_corner_pairs`` table, or from R1 with its scale
pass, whichever it does).

With ``--k4``, the small levels of the exact warp instead (:func:`k4_rows`):
at each of :data:`K4_LEVELS`, box and Gaussian window, a level's 5
iterations as K4 then K2 (with ``--parent``, that checkout's K4 and K2,
built by hand) against the route through K3 in turns, per call, device µs
and records, each with its bound; K4, K2 and K3 alone there; and K4 alone on
a rank's block of the row-sharded flow (:data:`K4_SHARDED`).

    python -m datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow [--height H --width W]
        [--parent DIR] [--tiny] [--small] [--k8] [--k7] [--k9] [--k4]
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
                                                                     cold_kernel_us,
                                                                     device_us_per_call, fmt,
                                                                     kernel_row, ms_per_call,
                                                                     sync)
from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.ops import level_kernels as lk
from datmo_using_optical_flow_tpu_torch.ops import poly_tiny
from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device

_WINDOW_ENTRIES = ("datmo_fused_iteration", "datmo_blur_solve")
_PARENT_ENTRIES = (*_WINDOW_ENTRIES, "datmo_poly_exp", "datmo_poly_exp_tiny",
                   "datmo_warp_matrices", "datmo_warp_packed")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K2's and K3's C signatures before their entries took the flow's numerators
# and 1 / det, by parameter count: an older parent declares these
_OLD_SIGNATURES = {("datmo_fused_iteration", 13): ([_P] * 6 + [_I, _I, _P, _I, _F, _I, _P], _I),
                   ("datmo_blur_solve", 10): ([_P, _P, _P, _I, _I, _P, _I, _F, _I, _P], _I),
                   ("datmo_warp_matrices", 9): ([_P] * 5 + [_I, _I, _I, _P], _I)}


def c_params(source: str, entry: str) -> int:
    """The parameter count of ``int entry(...)`` in a C source's text."""
    head = source[source.index(f"int {entry}("):]
    return len(head[:head.index(")")].split(","))


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


def _build_parent(parent: str | Path, name: str) -> tuple[ctypes.CDLL, str]:
    """``csrc/<name>.cu`` of the checkout at ``parent``, built by hand with the
    package's flags into ``build/parent_kernels/<its directory's name>/``,
    and its source text."""
    source = Path(parent) / "datmo_using_optical_flow_tpu_torch" / "csrc" / f"{name}.cu"
    out = build.BUILD_DIR.parent / "parent_kernels" / Path(parent).name / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), source.read_text()


def parent_library(parent: str | Path) -> ctypes.CDLL:
    """``flow_kernels.cu`` of the checkout at ``parent``, built by hand, with
    the C signatures of its entry points set; ``lib.tiny_program`` says
    whether its tiny form reads ``poly_tiny.tiny_program`` (else the plan,
    ``poly_tiny.plan_array``), ``lib.reads_r1`` whether its K9 quantises the
    corners it reads from R1 with its scale pass's scales (else it reads the
    packed corner table of ``pack_corner_pairs``: the same C signature)."""
    lib, text = _build_parent(parent, "flow_kernels")
    lib.reads_r1 = "datmo_corner_scale" in text
    for entry in (*_PARENT_ENTRIES, *(("datmo_corner_scale",) if lib.reads_r1 else ())):
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = _OLD_SIGNATURES.get((entry, c_params(text, entry)),
                                                      build._SIGNATURES[entry])
    lib.tiny_program = "TinyProgram" in text
    return lib


def parent_call(lib: ctypes.CDLL, args: tuple, winsize: int, gaussian: bool,
                flow_scale=None, terms: bool = False) -> Callable:
    """A call of the parent's K3 (four tensors ``R0, R1, dx, dy``, the flow
    times ``flow_scale`` when given) or K2 (one, ``M``) on the current stream,
    allocating its outputs as the wrapper does: ``(dx, dy)``, or with
    ``terms`` ``(nx, ny, idet)``.  A parent whose entries predate the carried
    flow takes neither ``flow_scale`` nor ``terms``."""
    entry = _WINDOW_ENTRIES[0] if len(args) == 4 else _WINDOW_ENTRIES[1]
    fn = getattr(lib, entry)
    first = args[0]
    h, w = first.shape[-2:]
    taps, scale = fk._window(winsize, gaussian)
    ptrs = [t.data_ptr() for t in args]
    carried = len(fn.argtypes) == len(build._SIGNATURES[entry][0])  # the 1 / det out, the flow
    if carried:
        ptrs = ptrs if len(args) == 1 else [*ptrs[:2], *fk._flow_args(*args[2:], flow_scale)]
    elif flow_scale is not None or terms:
        raise RuntimeError(f"the parent's {entry} predates the carried flow")

    def call():
        out = fk._outputs(h, w, first.device, terms)
        idet = [out[2].data_ptr() if terms else None] if carried else []
        build.check(fn(out[0].data_ptr(), out[1].data_ptr(), *idet, *ptrs, h, w,
                       taps.ctypes.data, winsize, scale, first.device.index,
                       torch.cuda.current_stream(first.device).cuda_stream), "parent")
        return out

    return call


def parent_warp(lib: ctypes.CDLL, R0, R1, dx, dy, flow_scale=None) -> Callable:
    """A call of the parent's K4 on the current stream (the flow times
    ``flow_scale`` when given), allocating M as the wrapper does; returns
    ``(M,)``."""
    fn = lib.datmo_warp_matrices
    _, h, w = R0.shape
    ptrs = [R0.data_ptr(), R1.data_ptr()]
    if len(fn.argtypes) == len(build._SIGNATURES["datmo_warp_matrices"][0]):
        ptrs += [*fk._flow_args(dx, dy, flow_scale), h, w, 0, 0, h, 0]  # a whole level
    elif flow_scale is not None:
        raise RuntimeError("the parent's datmo_warp_matrices predates the carried flow")
    else:
        ptrs += [dx.data_ptr(), dy.data_ptr(), h, w]

    def call():
        M = torch.empty((5, h, w), dtype=torch.float32, device=R0.device)
        build.check(fn(M.data_ptr(), *ptrs, R0.device.index,
                       torch.cuda.current_stream(R0.device).cuda_stream), "parent")
        return (M,)

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


def parent_scale(lib: ctypes.CDLL, R1) -> Callable:
    """A call of the parent's K9 scale pass (``lib.reads_r1``) on the current
    stream, allocating the scales as the wrapper does; returns ``(qs,)``."""
    _, h, w = R1.shape

    def call():
        qs = torch.empty(5, dtype=torch.float32, device=R1.device)
        build.check(lib.datmo_corner_scale(qs.data_ptr(), R1.data_ptr(), h, w, R1.device.index,
                                           torch.cuda.current_stream(R1.device).cuda_stream),
                    "parent")
        return (qs,)

    return call


def parent_packed(lib: ctypes.CDLL, R0, R1, dx, dy, flow_scale=None, pack=None) -> Callable:
    """A call of the parent's K9 on the current stream, allocating M as the
    wrapper does; returns ``(M,)``.  A parent that reads R1 takes its scale
    pass's scales (computed once, here), an older one the packed corner
    table that ``pack`` (its ``pack_corner_pairs``; default this build's)
    makes of R1."""
    _, h, w = R0.shape
    if lib.reads_r1:
        src, qs = R1, parent_scale(lib, R1)()[0]
    else:
        src, qs = (pack or fb.pack_corner_pairs)(R1)
    ptrs = [R0.data_ptr(), src.data_ptr(), qs.data_ptr(), *fk._flow_args(dx, dy, flow_scale)]

    def call():
        M = torch.empty((5, h, w), dtype=torch.float32, device=R0.device)
        build.check(lib.datmo_warp_packed(M.data_ptr(), *ptrs, h, w, R0.device.index,
                                          torch.cuda.current_stream(R0.device).cuda_stream),
                    "parent")
        return (M,)

    call.keep = (src, qs)  # the table or scales the launches read

    return call


def parent_poly_exp_tiny(lib: ctypes.CDLL, img: torch.Tensor, n: int, sigma: float) -> Callable:
    """A call of the parent's K1 tiny form on ``img`` with this package's
    rounding plan (``ops/poly_tiny``) in the form the parent reads; returns
    ``(planes,)``."""
    h, w = img.shape
    taps = fk._poly_taps(n, float(sigma))
    plan = (poly_tiny.tiny_program(h, w, n, float(sigma)) if lib.tiny_program
            else poly_tiny.plan_array(poly_tiny.tiny_plan(h, w, n, float(sigma))))
    ptr = img.data_ptr()

    def call():
        out = torch.empty((5, h, w), dtype=torch.float32, device=img.device)
        build.check(lib.datmo_poly_exp_tiny(out.data_ptr(), ptr, h, w, n,
                                            *(t.ctypes.data for t in taps), plan.ctypes.data,
                                            img.device.index,
                                            torch.cuda.current_stream(img.device).cuda_stream),
                    "parent")
        return (out,)

    return call


def in_turns(fns: dict, order: list, dev: torch.device, reps: int = 5, rounds: int = 3,
             launches: int = 1) -> dict:
    """Each of ``fns`` by device µs (a trace of ``reps`` calls) and per call
    (ms, median of ``2 reps``), called in ``order``, ``rounds`` times: the
    lists and their medians (device µs None on the CPU)."""
    got = {name: {"ms": [], "us": []} for name in fns}
    for _ in range(rounds):
        for name in order:
            got[name]["us"].append(device_us_per_call(fns[name], dev, reps, launches))
            got[name]["ms"].append(ms_per_call(fns[name], dev, 2 * reps))
    return {name: {**d, "ms_median": statistics.median(d["ms"]),
                   "us_median": None if None in d["us"] else statistics.median(d["us"])}
            for name, d in got.items()}


def against_parent(call: Callable, parent: Callable, plain: Callable, work: roofline.Work,
                   dev: torch.device, card: str, rounds: int = 3, reps: int = 5) -> dict:
    """Hold this build's ``call`` to ``plain`` bit for bit and the parent's
    within 1e-4 of the plain version's scale (a parent may round otherwise:
    its largest difference is reported), time ``plain`` per call, then take
    both device µs in turns (the parent, this build twice, the parent),
    ``rounds`` times; medians."""
    want = plain()
    plain_ms = ms_per_call(plain, dev, reps=3, warmup=1)
    if not all(torch.equal(g, x) for g, x in zip(call(), want)):
        raise AssertionError("this build differs from the plain version")
    parent_diff = max(float((g - x).abs().max()) for g, x in zip(parent(), want))
    scale = max(float(x.abs().max()) for x in want)
    if not parent_diff <= 1e-4 * scale:
        raise AssertionError(f"the parent differs from the plain version by {parent_diff:.3e}, "
                             f"more than 1e-4 of its scale {scale:.3e}")
    t = in_turns({"parent": parent, "package": call}, ["parent", "package", "package", "parent"],
                 dev, reps, rounds)
    us = {name: d["us"] for name, d in t.items()}
    ms = {name: d["ms"] for name, d in t.items()}
    med = {name: d["us_median"] for name, d in t.items()}
    med_ms = {name: d["ms_median"] for name, d in t.items()}
    bound = work.bound_us()
    print(f"{'':44s} in turns: device {med['package']:.1f} us (share "
          f"{bound / med['package']:.3f}), parent {med['parent']:.1f} us (share "
          f"{bound / med['parent']:.3f}); per call {med_ms['package']:.4f} ms, parent "
          f"{med_ms['parent']:.4f} ms; this build bit-equal to the plain version "
          f"({plain_ms:.3f} ms/call), the parent {parent_diff:.3e} from it [{card}]", flush=True)
    return {"plain_ms": plain_ms, "turns_device_us": us, "turns_median_us": med["package"],
            "parent_device_us": med["parent"], "parent_share_of_bound": bound / med["parent"],
            "parent_max_abs_diff": parent_diff, "turns_ms": ms,
            "turns_median_ms": med_ms["package"], "parent_ms": med_ms["parent"]}


def run(frames: np.ndarray, device: str | torch.device = "cuda", reps: int = 20,
        parent: str | Path | None = None, tiny: bool = False) -> dict:
    """Rows for the first two of ``frames`` ((n, H, W) uint8 BEV grids);
    ``parent`` as ``--parent``, ``tiny`` as ``--tiny``."""
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
    terms = fk.blur_solve(M, win, gaussian, terms=True)  # the flow between iterations
    print(f"micro_flow {h}x{w}: flow dx [{float(dx.min()):.2f}, {float(dx.max()):.2f}] "
          f"dy [{float(dy.min()):.2f}, {float(dy.max()):.2f}] [{card}]", flush=True)
    # the second level, and the coarsest level's packed M (K9, as the step
    # runs it with fast_warp)
    S0, S1 = inp.pyr1[-2], inp.pyr2[-2]
    _, sh, sw = S0.shape
    C0, C1 = inp.pyr1[0], inp.pyr2[0]
    _, ch, cw = C0.shape
    Mc = fk.warp_matrices_packed(C0, C1, fk.corner_scale(C1), *inp.flows[0])

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

    def packed_row(name: str, R0, R1, dx, dy) -> dict:
        lh, lw = R0.shape[-2:]
        work = roofline.warp_packed(lh, lw)
        scale = fk.corner_scale(R1)
        row = kernel_row(name, lambda: fk.warp_matrices_packed(R0, R1, scale, dx, dy), work,
                         dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: (fk.warp_matrices_packed(R0, R1, scale, dx, dy),),
                                      parent_packed(lib, R0, R1, dx, dy),
                                      lambda: (fk.warp_packed_reference(R0, R1, scale, dx, dy),),
                                      work, dev, card))
        return row

    def warp_row(name: str) -> dict:
        work = roofline.warp_matrices(h, w)
        row = kernel_row(name, lambda: fk.warp_matrices(R0, R1, dx, dy), work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: (fk.warp_matrices(R0, R1, dx, dy),),
                                      parent_warp(lib, R0, R1, dx, dy),
                                      lambda: (fk.warp_matrices_reference(R0, R1, dx, dy),),
                                      work, dev, card))
        return row

    rows = [
        window_row(f"K3 fused_iteration {h}x{w}", (R0, R1, dx, dy), gaussian),
        window_row(f"K3 fused_iteration {h}x{w}, Gaussian window", (R0, R1, dx, dy), True),
        kernel_row(f"K3 fused_iteration {h}x{w}, (nx, ny, 1/det) in and out",
                   lambda: fk.fused_iteration(R0, R1, terms[0], terms[1], win, gaussian,
                                              terms[2], True),
                   roofline.fused_iteration(h, w, win, 3, 3), dev, card, reps),
        warp_row(f"K4 warp_matrices {h}x{w}"),
        window_row(f"K2 blur_solve on K4's M {h}x{w}", (M,), gaussian),
        packed_row(f"K9 warp_matrices_packed {h}x{w}", R0, R1, dx, dy),
        window_row(f"K3 fused_iteration {sh}x{sw}, second level", (S0, S1, *inp.flows[-2]),
                   gaussian),
        window_row(f"K2 blur_solve on K9's M {ch}x{cw}, coarsest level", (Mc,), gaussian),
        packed_row(f"K9 warp_matrices_packed {ch}x{cw}, coarsest level", C0, C1,
                   *inp.flows[0]),
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
    if tiny:
        rows += tiny_rows(dev, card, lib, reps)
    return {"card": card, "device": str(dev), "shape": [h, w],
            "parent": None if parent is None else str(parent), "rows": rows}


# Tiny levels and images: K4 and K2 (Gaussian window) at levels of a
# one-valued attenuation and of a thin axis, K1's tiny form (h, w, poly_n,
# sigma) at a square, two tall images and a wide one
TINY_LEVELS = ((4, 4), (2, 64))
TINY_IMAGES = ((5, 5, 5, 5.0), (122, 5, 5, 5.0), (300, 7, 7, 1.5), (2, 1920, 5, 5.0))
# K2 (Gaussian) where every build takes the runtime-radius window stage: a
# level of one row, and a winsize other than 15
RUNTIME_WINDOWS = (((1, 64), 15), ((17, 33), 7))


def tiny_rows(dev: torch.device, card: str, lib: ctypes.CDLL | None, reps: int) -> list:
    """K4 and K2 (Gaussian, winsize 15) at :data:`TINY_LEVELS`, K2 at
    :data:`RUNTIME_WINDOWS` and K1 at :data:`TINY_IMAGES`, seeded normal
    planes and a 1.5 px flow, each held to its plain version and, with a
    parent library, timed beside it in turns; K1 also beside
    :func:`conv_yardstick` in turns (:func:`beside_conv`)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for h, w in TINY_LEVELS:
        R0, R1 = (torch.randn((5, h, w), device=dev, generator=gen) for _ in range(2))
        dx, dy = (torch.randn((h, w), device=dev, generator=gen) * 1.5 for _ in range(2))
        work = roofline.warp_matrices(h, w)
        row = kernel_row(f"K4 warp_matrices {h}x{w} (tiny level)",
                         lambda: fk.warp_matrices(R0, R1, dx, dy), work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: (fk.warp_matrices(R0, R1, dx, dy),),
                                      parent_warp(lib, R0, R1, dx, dy),
                                      lambda: (fk.warp_matrices_reference(R0, R1, dx, dy),),
                                      work, dev, card))
        rows.append(row)
        M = fk.warp_matrices(R0, R1, dx, dy)
        work = roofline.blur_solve(h, w, 15)
        row = kernel_row(f"K2 blur_solve {h}x{w}, Gaussian window (tiny level)",
                         lambda: fk.blur_solve(M, 15, True), work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: fk.blur_solve(M, 15, True),
                                      parent_call(lib, (M,), 15, True),
                                      lambda: fk.blur_solve_reference(M, 15, True), work, dev,
                                      card))
        rows.append(row)
    for (h, w), win in RUNTIME_WINDOWS:
        M = torch.rand((5, h, w), device=dev, generator=gen)
        work = roofline.blur_solve(h, w, win)
        row = kernel_row(f"K2 blur_solve {h}x{w} win {win}, Gaussian (runtime-radius stage)",
                         lambda: fk.blur_solve(M, win, True), work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: fk.blur_solve(M, win, True),
                                      parent_call(lib, (M,), win, True),
                                      lambda: fk.blur_solve_reference(M, win, True), work, dev,
                                      card))
        rows.append(row)
    for h, w, n, sigma in TINY_IMAGES:
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        work = roofline.poly_exp(h, w, n, sigma)
        k1 = lambda img=img, n=n, sigma=sigma: fk.poly_exp(img, n, sigma)  # noqa: E731
        row = kernel_row(f"K1 poly_exp {h}x{w} n={n} (tiny form)", k1, work, dev, card, reps)
        if lib is not None:
            row.update(against_parent(lambda: (k1(),), parent_poly_exp_tiny(lib, img, n, sigma),
                                      lambda: (fk.poly_exp_reference(img, n, sigma),),
                                      work, dev, card))
        row.update(beside_conv(k1, conv_yardstick(img, n, sigma), dev, card, reps))
        rows.append(row)
    return rows


def beside_conv(k1: Callable, conv: Callable, dev: torch.device, card: str, reps: int,
                rounds: int = 3) -> dict:
    """K1 and its :func:`conv_yardstick` in turns (the yardstick, K1 twice,
    the yardstick; ``rounds`` times): medians of ms per call and device µs."""
    got = {"k1_ms": [], "k1_us": [], "conv_ms": [], "conv_us": []}
    for _ in range(rounds):
        for name, fn in (("conv", conv), ("k1", k1), ("k1", k1), ("conv", conv)):
            got[f"{name}_ms"].append(ms_per_call(fn, dev, reps))
            got[f"{name}_us"].append(device_us_per_call(fn, dev))
    med = {k: statistics.median(v) for k, v in got.items()}
    print(f"{'':44s} beside F.conv2d in turns: per call {med['k1_ms']:.4f} ms, device "
          f"{med['k1_us']:.1f} us; F.conv2d {med['conv_ms']:.4f} ms, device "
          f"{med['conv_us']:.1f} us [{card}]", flush=True)
    return {"turns_conv": got, "k1_turns_ms": med["k1_ms"], "k1_turns_us": med["k1_us"],
            "conv_ms": med["conv_ms"], "conv_device_us": med["conv_us"]}


# K1's small shapes: the coarse levels of the pipelines (A's 200x200 and
# 60x60, 1080p's 97x173, 4K's 196x346 and 59x104, 720p's 216x384 and
# 65x115) and three tiny images (K1's tiny form)
SMALL_SHAPES = ((97, 173), (200, 200), (60, 60), (196, 346), (59, 104), (216, 384), (65, 115),
                (5, 122), (122, 5), (5, 5))


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


# ------------------------------------------------------------------ K8

# K8's C signatures in the two-pass form (two launches a level image, the
# resize of a stacked flow), by entry point: what a parent checkout may declare
_P64 = ctypes.c_int64
_K8_TWO_PASS = {"datmo_level_image": ([_P, _P, _P, _I, _I, _I, _I, *[_P] * 8, _I, _I, _P], _I),
                "datmo_blur": ([_P, _P, _P, _I, _I, _P, _P, _I, _I, _P], _I),
                "datmo_resize": ([_P, _P, _P64, _I, _I, _I, _I, *[_P] * 6, _F, _I, _P], _I)}


class ParentK8:
    """The K8 calls of a parent checkout's ``level_kernels.cu``, made as its
    wrapper made them: the two-pass form's per-level image (a scratch buffer
    of 2 x lh rows, or of the image for the blur) and its resize of the
    stacked flow; or, where the parent already has ``datmo_level_images``,
    through this package's plan."""

    def __init__(self, parent: str | Path, dev: torch.device):
        self.lib, text = _build_parent(parent, "level_kernels")
        self.dev = dev
        self.one_launch = "int datmo_level_images(" in text
        sigs = build._SIGNATURES if self.one_launch else _K8_TWO_PASS
        names = (("datmo_level_images", "datmo_resize") if self.one_launch
                 else tuple(_K8_TWO_PASS))
        for name in names:
            getattr(self.lib, name).argtypes, getattr(self.lib, name).restype = sigs[name]

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.dev).cuda_stream

    def level_image(self, im: torch.Tensor, scale: float, lh: int, lw: int) -> torch.Tensor:
        if self.one_launch:
            return self.level_images(im, ((scale, lh, lw),))[0]
        h, w = im.shape
        off, ws = lk._taps(*fb.level_blur(scale))
        out = torch.empty((lh, lw), dtype=torch.float32, device=self.dev)
        if (lh, lw) == (h, w):
            scratch = torch.empty_like(out)
            err = self.lib.datmo_blur(out.data_ptr(), im.data_ptr(), scratch.data_ptr(), h, w,
                                      off.ctypes.data, ws.ctypes.data, len(ws), self.dev.index,
                                      self._stream())
        else:
            y0, y1, wy, _ = fb.resize_table(h, lh, self.dev)
            x0, x1, wx, _ = fb.resize_table(w, lw, self.dev)
            scratch = torch.empty((2 * lh, w), dtype=torch.float32, device=self.dev)
            err = self.lib.datmo_level_image(
                out.data_ptr(), im.data_ptr(), scratch.data_ptr(), h, w, lh, lw, y0.data_ptr(),
                y1.data_ptr(), wy.data_ptr(), x0.data_ptr(), x1.data_ptr(), wx.data_ptr(),
                off.ctypes.data, ws.ctypes.data, len(ws), self.dev.index, self._stream())
        build.check(err, "parent level_image")
        return out

    def level_images(self, im: torch.Tensor, sizes) -> tuple[torch.Tensor, ...]:
        if not self.one_launch:
            return tuple(self.level_image(im, *lv) for lv in sizes)
        h, w = im.shape
        specs = lk._level_specs(tuple(sizes))
        plan = lk.level_plan(h, w, specs)
        out = torch.empty(plan.size, dtype=torch.float32, device=self.dev)
        words = lk._device_words("levels", (h, w, specs), self.dev)[0]
        build.check(self.lib.datmo_level_images(out.data_ptr(), im.data_ptr(), h, w,
                                                words.data_ptr(), plan.ntiles, plan.smem,
                                                self.dev.index, self._stream()), "parent")
        return tuple(out[o:o + lh * lw].view(lh, lw)
                     for o, (_, lh, lw) in zip(plan.offsets, sizes))

    def upsample(self, dx: torch.Tensor, dy: torch.Tensor, lh: int, lw: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        h, w = dx.shape
        out = torch.empty((2, lh, lw), dtype=torch.float32, device=self.dev)
        if self.one_launch:
            table = lk._device_words("resize", (h, w, lh, lw), self.dev)[0]
            err = self.lib.datmo_resize(out.data_ptr(), dx.data_ptr(), dy.data_ptr(), 0, 2, h, w,
                                        lh, lw, table.data_ptr(), 1.0, self.dev.index,
                                        self._stream())
        else:
            src = torch.stack([dx, dy])
            scale = float(np.float32(1.0))
            y0, y1, wy, _ = fb.resize_table(h, lh, self.dev)
            x0, x1, wx, _ = fb.resize_table(w, lw, self.dev)
            err = self.lib.datmo_resize(out.data_ptr(), src.data_ptr(), 2, h, w, lh, lw,
                                        y0.data_ptr(), y1.data_ptr(), wy.data_ptr(),
                                        x0.data_ptr(), x1.data_ptr(), wx.data_ptr(), scale,
                                        self.dev.index, self._stream())
        build.check(err, "parent resize")
        return out[0], out[1]


def k8_paths() -> tuple:
    """The flows whose pyramids K8 builds: (tag, (h, w), Farnebäck settings)."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import flow_batched_720p as fbm
    from datmo_using_optical_flow_tpu_torch.benchmarks import from_points as fpb
    from datmo_using_optical_flow_tpu_torch.benchmarks import stream_4k
    from datmo_using_optical_flow_tpu_torch.benchmarks.stream_1080p import config

    fp = fpb.config()
    return (("1080p", (1080, 1920), config(1080, 1920).farneback),
            ("from points", fp.grid_shape, fp.farneback),
            ("4K", (stream_4k.H, stream_4k.W), config(stream_4k.H, stream_4k.W).farneback),
            ("720p", (fbm.H, fbm.W), FarnebackConfig()))


def k8_rows(dev: torch.device, card: str, parent: ParentK8 | None, reps: int = 20,
            seed: int = 8) -> list:
    """K8 at each path of :func:`k8_paths` on a uniform random image from
    ``seed``: the frame's level images in one launch, each level alone, and
    the flow's upsample at each level transition in the main path's form
    (two planes, scale 1.0), each held to its plain version and, with a
    parent, timed beside the parent's calls in turns."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []

    def row(name, call, par, plain, work):
        r = kernel_row(name, call, work, dev, card, reps)
        if parent is not None:
            r.update(against_parent(call, par, plain, work, dev, card))
        rows.append(r)

    for tag, (h, w), c in k8_paths():
        img = torch.rand((h, w), device=dev, generator=gen) * 255
        sizes = [(s, lh, lw) for _, s, lh, lw in level_sizes(h, w, c.pyr_scale, c.levels)]
        taps = [len(lk._taps(*fb.level_blur(s))[1]) for s, _, _ in sizes]
        row(f"K8 level images {h}x{w} ({tag}), one launch",
            lambda: lk.level_images(img, sizes),
            None if parent is None else lambda: parent.level_images(img, sizes),
            lambda: fb.level_images_reference(img, sizes),
            roofline.level_images(h, w, [(lh, lw, n) for (_, lh, lw), n in zip(sizes, taps)]))
        for (s, lh, lw), n in zip(sizes, taps):
            row(f"K8 level image {h}x{w} -> {lh}x{lw}, {n} taps ({tag})",
                lambda s=s, lh=lh, lw=lw: (lk.level_image(img, s, lh, lw),),
                None if parent is None else (
                    lambda s=s, lh=lh, lw=lw: (parent.level_image(img, s, lh, lw),)),
                lambda s=s, lh=lh, lw=lw: (fb.level_image_reference(img, s, lh, lw),),
                roofline.level_image(h, w, lh, lw, n))
        for (_, ph, pw), (_, lh, lw) in zip(sizes, sizes[1:]):
            dx, dy = (torch.randn((ph, pw), device=dev, generator=gen) * 3 for _ in range(2))
            row(f"K8 upsample 2x{ph}x{pw} -> {lh}x{lw} ({tag})",
                lambda dx=dx, dy=dy, lh=lh, lw=lw: lk.upsample(dx, dy, lh, lw),
                None if parent is None else (
                    lambda dx=dx, dy=dy, lh=lh, lw=lw: parent.upsample(dx, dy, lh, lw)),
                lambda dx=dx, dy=dy, lh=lh, lw=lw: tuple(
                    fb.resize_bilinear_reference(torch.stack([dx, dy]), lh, lw)),
                roofline.resize(2, ph, pw, lh, lw, False))
    return rows


def host_us(parts: dict, dev: torch.device, n: int) -> dict:
    """Host µs per call of each part, over ``n`` calls in a Python loop, the
    card synchronised before and after each part."""
    import time

    us = {}
    for label, body in parts.items():
        body()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        us[label] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize(dev)
    return us


def upsample_path(dev: torch.device, card: str, parent: ParentK8 | None = None,
                  shape: tuple = (97, 173), out: tuple = (324, 576), n: int = 1000) -> dict:
    """Host µs per call of each part of the upsample's launch path at the
    main path's small transition (97x173 -> 324x576 at 1080p), as
    ``chip_smoke``'s ``launch_path_breakdown`` splits K6's: this package's
    (its checks, the float32 scale, the cached table, the output's
    allocation, the ctypes call that launches the kernel, the two views) and,
    with a parent in the two-pass form, the parent's (the stack of the two
    planes, its checks, the scale through numpy, two table lookups, the
    allocation, its ctypes call of 15 arguments, the views); each beside the
    whole call and ``F.interpolate`` of the stack."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    dx, dy = (torch.randn(shape, device=dev, generator=gen) for _ in range(2))
    (h, w), (lh, lw) = shape, out
    stacked = torch.stack([dx, dy])[None]
    fn, stream = lk._RESIZE.resolve()
    index = dev.index
    table = lk._device_words("resize", (h, w, lh, lw), dev)[0]
    buf = torch.empty((2, lh, lw), dtype=torch.float32, device=dev)
    args = (buf.data_ptr(), dx.data_ptr(), dy.data_ptr(), 0, 2, h, w, lh, lw, table.data_ptr(),
            1.0, index, stream(index))
    parts = {"checks (device, dtype, shape)": lambda: (
                 fk._on_cuda(dx, dy), dx.dtype != torch.float32, dy.dtype != torch.float32,
                 dx.ndim, dx.shape == dy.shape, dx.numel(), dx.contiguous(), dy.contiguous()),
             "scale to float32 (cached)": lambda: lk._scale32(1.0),
             "table lookup (uploaded once)": lambda: lk._device_words(
                 "resize", (h, w, lh, lw), dev),
             "allocation (torch.empty)": lambda: torch.empty((2, lh, lw), dtype=torch.float32,
                                                             device=dev),
             "raw stream lookup": lambda: stream(index),
             "ctypes call (device guard, launch)": lambda: fn(*args),
             "two views (unbind)": lambda: buf.unbind(0),
             "whole upsample() call": lambda: lk.upsample(dx, dy, lh, lw),
             "F.interpolate of the stack": lambda: F.interpolate(
                 stacked, size=(lh, lw), mode="bilinear", align_corners=False)}
    rec = {"package": host_us(parts, dev, n)}
    if parent is not None and not parent.one_launch:
        old = parent.lib.datmo_resize
        src = torch.stack([dx, dy])
        y0, y1, wy, _ = fb.resize_table(h, lh, dev)
        x0, x1, wx, _ = fb.resize_table(w, lw, dev)
        old_args = (buf.data_ptr(), src.data_ptr(), 2, h, w, lh, lw, y0.data_ptr(),
                    y1.data_ptr(), wy.data_ptr(), x0.data_ptr(), x1.data_ptr(), wx.data_ptr(),
                    1.0, index, stream(index))
        rec["parent"] = host_us({
            "torch.stack of the two planes": lambda: torch.stack([dx, dy]),
            "checks (device, dtype, shape)": lambda: (
                fk._on_cuda(src), src.dtype != torch.float32, src.ndim, src.numel(),
                src.contiguous()),
            "scale through numpy": lambda: float(np.float32(1.0)),
            "two table lookups": lambda: (fb.resize_table(h, lh, dev),
                                          fb.resize_table(w, lw, dev)),
            "allocation (torch.empty)": lambda: torch.empty((2, lh, lw), dtype=torch.float32,
                                                            device=dev),
            "raw stream lookup": lambda: stream(index),
            "ctypes call (15 arguments, device guard, launch)": lambda: old(*old_args),
            "two views": lambda: (buf[0], buf[1]),
            "whole call (stack, then the resize)": lambda: parent.upsample(dx, dy, lh, lw)},
            dev, n)
    for who, us in rec.items():
        print(f"upsample {h}x{w} -> {lh}x{lw} launch path ({who}), host us per call over {n} "
              f"calls: " + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + f" [{card}]",
              flush=True)
    return rec


# ------------------------------------------------------------------ K9

# K9's shapes: the pipelines' small levels (1080p's 97x173 with zero flow
# and with the carried (nx, ny, 1/det), from points' 200x200 and 60x60, 4K's
# 59x104, 720p's 65x115) and 1080x1920, a diagnostic no pipeline packs
K9_SHAPES = ((97, 173), (200, 200), (60, 60), (59, 104), (65, 115), (1080, 1920))


def parent_farneback(parent: str | Path):
    """The parent checkout's ``ops/farneback.py`` loaded as a module of its
    own, for its ``pack_corner_pairs`` (the table an older K9 reads)."""
    import importlib.util

    path = Path(parent) / "datmo_using_optical_flow_tpu_torch" / "ops" / "farneback.py"
    spec = importlib.util.spec_from_file_location("parent_farneback", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def records_per_call(fn: Callable, dev: torch.device, reps: int = 3) -> float:
    """Device records (kernels, copies, fills) per call of ``fn`` in one
    profiler trace of ``reps`` calls, the sentinels not counted."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    records = measure.trace_records(fn, dev, reps)
    return sum(measure._SENTINEL_NAME not in name for name, _ in records) / reps


def k9_inputs(dev: torch.device, seed: int = 9) -> list:
    """K9's cases at :data:`K9_SHAPES`: (label, R0, R1, dx, dy, flow_scale).
    1080p's coarsest level from two ``make_frames`` frames' pyramids, the
    other shapes the planes of K1 on seeded uniform images; zero flow, and at
    97x173 also the flow the refinement carries between iterations (the
    numerators and 1 / det of K2 on K9's M)."""
    c = FarnebackConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for h, w in K9_SHAPES:
        if (h, w) == (97, 173):
            R0, R1 = (fb.build_pyramid(torch.as_tensor(f, device=dev).float(), c.pyr_scale,
                                       c.levels, c.poly_n, c.poly_sigma)[0]
                      for f in make_frames(2, 1080, 1920, seed=0))
        else:
            R0, R1 = (fk.poly_exp(torch.rand((h, w), device=dev, generator=gen) * 255, 5, 5.0)
                      for _ in range(2))
        carried = (h, w) == (97, 173)
        h, w = R0.shape[1:]
        zero = torch.zeros((h, w), dtype=torch.float32, device=dev)
        cases.append((f"{h}x{w} zero flow", R0, R1, zero, zero, None))
        if carried:
            M = fk.warp_matrices_packed(R0, R1, fk.corner_scale(R1), zero, zero)
            nx, ny, idet = fk.blur_solve(M, c.winsize, False, terms=True)
            cases.append((f"{h}x{w} carried flow (nx, ny) * 1/det", R0, R1, nx, ny, idet))
    return cases


def k9_rows(dev: torch.device, card: str, parent: str | Path | None, reps: int = 10,
            iterations: int = 5) -> list:
    """K9 at each case of :func:`k9_inputs`, each held bit for bit to its
    plain version: the scale pass beside ``torch.amax(R1.abs(), (1, 2))`` in
    turns; the warp through its wrapper (per call, device µs, bound); and a
    level's whole packed warp, the scale pass and ``iterations`` warps, by
    device records, device µs and per call.  With ``parent``, that
    checkout's K9 (built by hand) in turns beside this build's, alone and for
    the whole level: a parent that reads R1 with its scale pass (its scale
    pass in the scale pass's turns too), an older one over its
    ``pack_corner_pairs`` table (loaded from its ``ops/farneback.py``)."""
    lib = None if parent is None else parent_library(parent)
    pfb = None if parent is None else parent_farneback(parent)
    rows = []
    for label, R0, R1, dx, dy, s in k9_inputs(dev):
        _, h, w = R0.shape
        scale = fk.corner_scale(R1)
        want_scale = fk.corner_scale_reference(R1)
        want = fk.warp_packed_reference(R0, R1, scale, dx, dy, s)
        if not rk.bits_equal(scale, want_scale):
            raise AssertionError(f"K9 scale pass {label}: differs from its plain version")
        work, swork = roofline.warp_packed(h, w), roofline.corner_scale(h, w)
        row = {"name": f"K9 {label}", "shape": [h, w], "bound_us": work.bound_us(),
               "bound_by": work.bound_by(), "scale_bound_us": swork.bound_us()}
        # the scale pass beside one PyTorch call of the same maxima (and the parent's)
        sfns = {"package": lambda R1=R1: fk.corner_scale(R1),
                "amax": lambda R1=R1: torch.amax(R1.abs(), (1, 2))}
        if lib is not None and lib.reads_r1:
            sfns["parent"] = parent_scale(lib, R1)
            if not rk.bits_equal(sfns["parent"]()[0], want_scale):
                raise AssertionError(f"K9 scale pass {label}: the parent differs from the "
                                     "plain version")
        st = in_turns(sfns, [*sfns, *reversed(sfns)], dev, reps)
        row.update(scale_ms=st["package"]["ms_median"], scale_us=st["package"]["us_median"],
                   amax_ms=st["amax"]["ms_median"], amax_us=st["amax"]["us_median"],
                   scale_turns=st,
                   scale_plain_ms=ms_per_call(lambda R1=R1: fk.corner_scale_reference(R1), dev,
                                              3, 1))
        if "parent" in st:
            row.update(parent_scale_ms=st["parent"]["ms_median"],
                       parent_scale_us=st["parent"]["us_median"])
        # the wrapper, and the parent's K9 in turns
        call = (lambda R0=R0, R1=R1, scale=scale, dx=dx, dy=dy, s=s:
                fk.warp_matrices_packed(R0, R1, scale, dx, dy, s))
        row.update(plain_ms=ms_per_call(lambda: fk.warp_packed_reference(R0, R1, scale, dx, dy,
                                                                         s), dev, 3, 1),
                   enqueue_us=enqueue_us(call, dev),
                   scale_enqueue_us=enqueue_us(lambda R1=R1: fk.corner_scale(R1), dev))
        fns = {"package": call}
        level = {"package": lambda: [fk.warp_matrices_packed(R0, R1, sc, dx, dy, s)
                                     for sc in [fk.corner_scale(R1)] for _ in range(iterations)]}
        order = ["package", "package"]
        if lib is not None:
            fns["parent"] = parent_packed(lib, R0, R1, dx, dy, s, pfb.pack_corner_pairs)
            if not rk.bits_equal(fns["parent"]()[0], want):
                raise AssertionError(f"K9 {label}: the parent differs from the plain version")

            def parent_level(R0=R0, R1=R1, dx=dx, dy=dy, s=s):
                call = parent_packed(lib, R0, R1, dx, dy, s, pfb.pack_corner_pairs)
                return [call() for _ in range(iterations)]

            level["parent"] = parent_level
            order = ["parent", "package", "package", "parent"]
        if not rk.bits_equal(call(), want):
            raise AssertionError(f"K9 {label}: differs from its plain version")
        kt = in_turns(fns, order, dev, reps)
        lt = in_turns(level, order, dev, reps, launches=iterations)
        row.update(ms=kt["package"]["ms_median"], device_us=kt["package"]["us_median"],
                   share_of_bound=work.bound_us() / kt["package"]["us_median"],
                   level_ms=lt["package"]["ms_median"], level_us=lt["package"]["us_median"],
                   level_records=records_per_call(level["package"], dev), turns=kt,
                   level_turns=lt)
        if lib is not None:
            row.update(parent_ms=kt["parent"]["ms_median"],
                       parent_device_us=kt["parent"]["us_median"],
                       parent_share_of_bound=work.bound_us() / kt["parent"]["us_median"],
                       parent_level_ms=lt["parent"]["ms_median"],
                       parent_level_us=lt["parent"]["us_median"],
                       parent_level_records=records_per_call(level["parent"], dev))
        print(f"K9 {label}: {row['ms']:.4f} ms/call (enqueue {row['enqueue_us']:.1f} us), device "
              f"{row['device_us']:.2f} us (bound {row['bound_us']:.3f} us, share "
              f"{row['share_of_bound']:.3f}); scale pass {row['scale_ms']:.4f} ms, device "
              f"{row['scale_us']:.2f} us (torch.amax {row['amax_ms']:.4f} ms, "
              f"{row['amax_us']:.2f} us"
              + ("" if "parent" not in st else
                 f"; parent's {row['parent_scale_ms']:.4f} ms, {row['parent_scale_us']:.2f} us")
              + f"); level ({iterations} warps) {row['level_ms']:.4f} ms, device "
              f"{row['level_us']:.2f} us, {row['level_records']:.1f} records"
              + ("" if lib is None else
                 f"; parent {row['parent_ms']:.4f} ms, device {row['parent_device_us']:.2f} us, "
                 f"level {row['parent_level_ms']:.4f} ms, device "
                 f"{row['parent_level_us']:.2f} us, {row['parent_level_records']:.1f} records")
              + f"; plain {row['plain_ms']:.3f} ms [{card}]", flush=True)
        rows.append(row)
    return rows


def packed_path(dev: torch.device, card: str, shape: tuple = (97, 173), n: int = 1000) -> dict:
    """Host µs per call of each part of K9's launch path at 1080p's coarsest
    level (zero flow): its checks, the device test, the allocation, the flow
    arguments, the raw stream lookup and the ctypes call, beside the whole
    call and the scale pass's whole call."""
    gen = torch.Generator(device=dev).manual_seed(23)
    h, w = shape
    R0, R1 = (torch.randn((5, h, w), device=dev, generator=gen) for _ in range(2))
    dx = dy = torch.zeros((h, w), device=dev)
    scale = fk.corner_scale(R1)
    fn, stream = fk._WARP_PACKED.resolve()
    index = dev.index
    M = torch.empty((5, h, w), dtype=torch.float32, device=dev)
    args = (M.data_ptr(), R0.data_ptr(), R1.data_ptr(), scale.data_ptr(),
            *fk._flow_args(dx, dy, None), h, w, index, stream(index))
    us = host_us({
        "checks (shapes, dtypes, contiguity)": lambda: (
            fk._check_planes_and_flow(R0, R1, dx, dy, None), fk._check(scale, "scale", (5,))),
        "device test (_on_cuda)": lambda: fk._on_cuda(R0, R1, scale, dx, dy, dx),
        "allocation (torch.empty)": lambda: torch.empty((5, h, w), dtype=torch.float32,
                                                        device=dev),
        "flow arguments": lambda: fk._flow_args(dx, dy, None),
        "raw stream lookup": lambda: stream(index),
        "ctypes call (13 arguments, device guard, launch)": lambda: fn(*args),
        "whole warp_matrices_packed call": lambda: fk.warp_matrices_packed(R0, R1, scale, dx, dy),
        "whole corner_scale call": lambda: fk.corner_scale(R1)}, dev, n)
    print(f"K9 {h}x{w} launch path, host us per call over {n} calls: "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + f" [{card}]", flush=True)
    return us


# ------------------------------------------------------------------ K4 and the exact route

# The small levels of the exact warp that K3 runs (ops/warp.exact_fused), as
# the paths that run them build them: (frame height, width, level height,
# width).  compat's and the quality run's 60x60 and 200x200 levels of a
# 200x200 grid (the 200x200 takes the 60x60's flow), the 1080p flow's
# 97x173 and the sharded flow's replicated 98x173 (at 1088x1920).
K4_LEVELS = ((200, 200, 60, 60), (1080, 1920, 97, 173), (1088, 1920, 98, 173),
             (200, 200, 200, 200))
# A rank's level-0 block of the row-sharded flow at 1088x1920 over 4 ranks:
# (rows per rank, width, warp halo, ranks); K4 still stores its M there
K4_SHARDED = (272, 1920, 16, 4)


def k4_level_inputs(fh: int, fw: int, h: int, w: int, dev: torch.device,
                    seed: int = 4) -> tuple:
    """(R0, R1, dx, dy, flow_scale) of the (h, w) level of two ``make_frames``
    frames of (fh, fw), as the exact refinement enters it: the pyramids'
    planes, zero flow on the coarsest level, else the flow of the levels
    below (``flow_from_pyramids``, exact warp) upsampled, times
    1 / pyr_scale."""
    c = FarnebackConfig()
    pyr1, pyr2 = (fb.build_pyramid(torch.as_tensor(f, device=dev).float(), c.pyr_scale,
                                   c.levels, c.poly_n, c.poly_sigma)
                  for f in make_frames(2, fh, fw, seed=seed))
    i = [tuple(p.shape[1:]) for p in pyr1].index((h, w))
    if i == 0:
        zero = torch.zeros((h, w), dtype=torch.float32, device=dev)
        return pyr1[0], pyr2[0], zero, zero.clone(), None
    flow = fb.flow_from_pyramids(pyr1[:i], pyr2[:i], c.pyr_scale, c.winsize, c.iterations,
                                 False)
    dx, dy = fb.upsample(flow[..., 0].contiguous(), flow[..., 1].contiguous(), h, w)
    return pyr1[i], pyr2[i], dx, dy, float(np.float32(1.0 / c.pyr_scale))


def level_run(iteration: Callable, R0, R1, dx, dy, flow_scale, winsize: int, gaussian: bool,
              iterations: int) -> Callable:
    """A level's ``iterations``, each one ``iteration`` (K3's wrapper's
    signature: K3, or K4 then K2, :func:`k4_then_k2`), the flow carried
    between them as the numerators and 1 / det."""
    def level():
        vx, vy, s = dx, dy, flow_scale
        for i in range(iterations):
            terms = i < iterations - 1
            out = iteration(R0, R1, vx, vy, winsize, gaussian, s, terms)
            if terms:
                vx, vy, s = out
        return out

    return level


def k4_then_k2(warp: Callable, window: Callable) -> Callable:
    """One iteration as the small exact levels ran before the route: K4's M
    stored (``warp``), then K2 on it (``window``)."""
    return lambda R0, R1, dx, dy, winsize, gaussian, s, terms: window(
        warp(R0, R1, dx, dy, s), winsize, gaussian, terms)


def _route_work(h: int, w: int, winsize: int, iterations: int, fused: bool) -> roofline.Work:
    """The bound's work of a level's ``iterations``: K3 each (M on chip), or
    K4 then K2 (M stored and reloaded); the flow in as two planes first,
    then as the numerators and 1 / det, out as those but last."""
    total = roofline.Work(0, 0)
    for i in range(iterations):
        pin, pout = (2 if i == 0 else 3), (3 if i < iterations - 1 else 2)
        parts = ([roofline.fused_iteration(h, w, winsize, pin, pout)] if fused else
                 [roofline.warp_matrices(h, w, pin), roofline.blur_solve(h, w, winsize, pout)])
        for part in parts:
            total = roofline.Work(total.bytes + part.bytes, total.ops + part.ops)
    return total


def k4_rows(dev: torch.device, card: str, parent: str | Path | None = None,
            levels: tuple = K4_LEVELS, sharded: tuple = K4_SHARDED, reps: int = 10,
            iterations: int = 5, rounds: int = 3) -> dict:
    """The small levels of the exact warp, before and after the route, at
    each of ``levels`` with the box and the Gaussian window (winsize 15):
    the level's ``iterations`` as K4 then K2 (this build's, or with
    ``parent`` that checkout's, built by hand) against the route
    (``farneback_level(..., fast_warp=False)``: K3 each iteration) and, with
    ``parent``, the parent's K3 on the same route, all held bit for bit to
    the plain versions and to each other, in turns (the old route, the
    parent's K3, the route twice, the parent's K3, the old route; three
    times): per call ms and
    device µs of the level and per iteration, device records, and the bound
    of each route's work (``roofline.fused_iteration``,
    ``roofline.warp_matrices`` + ``roofline.blur_solve``).  Then K4, K2 and
    K3 alone at each level (mode 0 and the level's first flow, in turns),
    and K4 alone on a rank's block of the row-sharded flow (``sharded``:
    rows per rank, width, warp halo, ranks), rank 0 and an inner rank, with
    its launches per sharded flow call, back to back and with the L2 cache
    cleared before each call (``measure.cold_kernel_us``)."""
    from datmo_using_optical_flow_tpu_torch.parallel.sharded_flow import sharded_flow_launches

    if parent is not None and dev.type != "cuda":
        raise RuntimeError("the parent's kernels are built and timed on the card")
    c = FarnebackConfig()
    win = c.winsize
    lib = None if parent is None else parent_library(parent)
    if lib is None:
        old_warp, old_window, parent_fused = fk.warp_matrices, fk.blur_solve, None
    else:
        def old_warp(R0, R1, dx, dy, s):
            return parent_warp(lib, R0, R1, dx, dy, s)()[0]

        def old_window(M, winsize, gaussian, terms):
            return parent_call(lib, (M,), winsize, gaussian, terms=terms)()

        def parent_fused(R0, R1, dx, dy, winsize, gaussian, s, terms):
            return parent_call(lib, (R0, R1, dx, dy), winsize, gaussian, s, terms)()
    on_card = dev.type == "cuda"
    levels_out, kernels = [], []
    for fh, fw, h, w in levels:
        R0, R1, dx, dy, s = k4_level_inputs(fh, fw, h, w, dev)
        for gaussian in (False, True):
            label = f"{h}x{w} {'Gaussian' if gaussian else 'box'}" + (
                "" if s is None else ", the flow of the level below times 1/pyr_scale")
            route = (lambda R0=R0, R1=R1, dx=dx, dy=dy, s=s, g=gaussian:
                     fb.farneback_level(R0, R1, dx, dy, win, iterations, False, g, s))
            old = level_run(k4_then_k2(old_warp, old_window), R0, R1, dx, dy, s, win, gaussian,
                            iterations)
            plain = level_run(fk.fused_iteration_reference, R0, R1, dx, dy, s, win, gaussian,
                              iterations)
            fk.reset_launches()
            got = route()
            launches = {k: v for k, v in fk.LAUNCHES.items() if v}
            want = plain()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"route {label}: differs from the plain versions")
            if not all(torch.equal(a, b) for a, b in zip(old(), got)):
                raise AssertionError(f"route {label}: differs from K4 then K2")
            fns = {"k4_k2": old, "route": route}
            order = ["k4_k2", "route", "route", "k4_k2"]
            if parent_fused is not None:  # the parent's K3 on the same route
                fns["parent_route"] = level_run(parent_fused, R0, R1, dx, dy, s, win, gaussian,
                                                iterations)
                if not all(torch.equal(a, b) for a, b in zip(fns["parent_route"](), got)):
                    raise AssertionError(f"route {label}: the parent's K3 differs")
                order = ["k4_k2", "parent_route", "route", "route", "parent_route", "k4_k2"]
            t = in_turns(fns, order, dev, reps, rounds, iterations)
            works = {k: _route_work(h, w, win, iterations, k != "k4_k2") for k in fns}
            row = {"name": f"exact level {label}", "shape": [h, w], "gaussian": gaussian,
                   "iterations": iterations, "launches": launches, "turns": t,
                   "plain_ms": ms_per_call(plain, dev, 2, 1)}
            for k, d in t.items():
                us = d["us_median"]
                row[k] = {"ms": d["ms_median"], "ms_per_iteration": d["ms_median"] / iterations,
                          "device_us": us,
                          "device_us_per_iteration": None if us is None else us / iterations,
                          "records": records_per_call(fns[k], dev) if on_card else None,
                          "bound_us": works[k].bound_us(), "bound_by": works[k].bound_by(),
                          "share_of_bound": None if us is None else works[k].bound_us() / us}
            levels_out.append(row)
            print(f"exact level {label}, {iterations} iterations: K4 then K2"
                  f"{'' if lib is None else ' (parent)'} {row['k4_k2']['ms']:.4f} ms, device "
                  f"{fmt(row['k4_k2']['device_us'], '.2f')} us, "
                  f"{fmt(row['k4_k2']['records'], '.1f')} records (bound "
                  f"{row['k4_k2']['bound_us']:.3f} us); route (K3) {row['route']['ms']:.4f} ms, "
                  f"device {fmt(row['route']['device_us'], '.2f')} us, "
                  f"{fmt(row['route']['records'], '.1f')} records (bound "
                  f"{row['route']['bound_us']:.3f} us, share "
                  f"{fmt(row['route']['share_of_bound'])})"
                  + ("" if "parent_route" not in row else
                     f"; the parent's K3 {row['parent_route']['ms']:.4f} ms, device "
                     f"{fmt(row['parent_route']['device_us'], '.2f')} us")
                  + f"; launches {launches}; bit-equal to "
                  f"K4 then K2 and the plain versions (plain {row['plain_ms']:.3f} ms) [{card}]",
                  flush=True)
        # each kernel alone at the level's first flow, box window, in turns
        M = fk.warp_matrices(R0, R1, dx, dy, s)
        fns = {"K4": lambda: fk.warp_matrices(R0, R1, dx, dy, s),
               "K2": lambda: fk.blur_solve(M, win, False, True),
               "K3": lambda: fk.fused_iteration(R0, R1, dx, dy, win, False, s, True)}
        works = {"K4": roofline.warp_matrices(h, w), "K2": roofline.blur_solve(h, w, win, 3),
                 "K3": roofline.fused_iteration(h, w, win, 2, 3)}
        t = in_turns(fns, [*fns, *reversed(fns)], dev, reps, rounds)
        for k, d in t.items():
            us = d["us_median"]
            kernels.append({"name": f"{k} {h}x{w} alone", "shape": [h, w], "ms": d["ms_median"],
                            "device_us": us, "bound_us": works[k].bound_us(),
                            "bound_by": works[k].bound_by(),
                            "share_of_bound": None if us is None else works[k].bound_us() / us,
                            "launches_per_level_before": iterations if k != "K3" else 0,
                            "launches_per_level_after": iterations if k == "K3" else 0})
            print(f"{k} {h}x{w} alone: {d['ms_median']:.4f} ms/call, device {fmt(us, '.2f')} us "
                  f"(bound {works[k].bound_us():.3f} us, {works[k].bound_by()}, share "
                  f"{fmt(kernels[-1]['share_of_bound'])}) [{card}]", flush=True)
    rows_per_rank, width, halo, ranks = sharded
    total = rows_per_rank * ranks
    per_call = sharded_flow_launches(total, width)["warp_matrices"]
    gen = torch.Generator(device=dev).manual_seed(14)
    R0 = fk.poly_exp(torch.rand((rows_per_rank, width), device=dev, generator=gen) * 255, 5, 5.0)
    R1 = fk.poly_exp(torch.rand((rows_per_rank + 2 * halo, width), device=dev, generator=gen)
                     * 255, 5, 5.0)
    yy, xx = torch.meshgrid(torch.linspace(0, 3.0, rows_per_rank, device=dev),
                            torch.linspace(0, 5.0, width, device=dev), indexing="ij")
    dx, dy = (2.0 * torch.sin(xx + yy)).contiguous(), (2.0 * torch.cos(xx - yy)).contiguous()
    sharded_rows = []
    for rank in (0, 1):
        rows = (rank * rows_per_rank, halo, total)
        call = lambda rows=rows: fk.warp_matrices(R0, R1, dx, dy, rows=rows)
        if not torch.equal(call(), fk.warp_matrices_reference(R0, R1, dx, dy, rows=rows)):
            raise AssertionError(f"K4 sharded block rank {rank}: differs from its plain version")
        work = roofline.warp_matrices(rows_per_rank, width, 2, halo)
        row = kernel_row(f"K4 warp_matrices, rank {rank}'s {rows_per_rank}x{width} block "
                         f"(+{halo} rows each side), {total}x{width} over {ranks}", call, work,
                         dev, card, reps)
        # back to back the calls find R0, R1 and the flow in L2 (36.7 MB of
        # its 50 MB); in the sharded flow K2, the halo exchange and K1 come
        # between two K4, so read it with L2 cleared before each call too
        cold = cold_kernel_us(call, dev, "warp_matrices_kernel")
        row.update(rank=rank, launches_per_sharded_call=per_call, device_us_cold_l2=cold,
                   share_of_bound_cold_l2=None if cold is None else work.bound_us() / cold)
        print(f"  L2 cleared before each call: device {fmt(cold, '.2f')} us, share "
              f"{fmt(row['share_of_bound_cold_l2'])} [{card}]", flush=True)
        sharded_rows.append(row)
    return {"card": card, "device": str(dev), "parent": None if parent is None else str(parent),
            "levels": levels_out, "kernels": kernels, "sharded": sharded_rows}


# ------------------------------------------------------------------ K7's sum of squares

# The main paths' sites of K7's sum of squares of a difference: (label, a's
# shape, b's shape, root), as the 1080p step (tracker A, 32 calls a step) and
# the GMFA step at reference load (its cost matrix, ICP's 102,400 rows, the
# NN block table's 400 blocks by 400 tiles) call it
K7_SITES = (("tracker A's association, models/tracker_a.py", (4,), (64, 4), True),
            ("GMFA's cost, models/gmfa.py", (64, 1, 4), (1, 32, 4), True),
            ("ICP's shell, ops/icp.py", (102400, 3), (102400, 3), True),
            ("ICP's certificate and d2, ops/icp.py", (102400, 3), (102400, 3), False),
            ("the block table's ball distance, ops/nn_kernels.py", (400, 1, 3), (1, 400, 3),
             True))


def sumsq_library(a: torch.Tensor, b: torch.Tensor | None, root: bool) -> Callable:
    """The one PyTorch call closest to K7's sum of squares on these operands:
    ``F.pairwise_distance(a, b, eps=0.0)`` row by row, ``torch.cdist`` (no
    matrix product) for a broadcast cost matrix (n, 1, k) against (1, m, k),
    ``torch.linalg.vector_norm`` (``vecdot`` without the root) of one
    operand.  Where a site takes no root the distance calls stand all the
    same: the closest single call.  Timed beside K7; the port does not use
    it."""
    import torch.nn.functional as F

    if b is None:
        return ((lambda: torch.linalg.vector_norm(a, dim=-1)) if root
                else (lambda: torch.linalg.vecdot(a, a)))
    if a.ndim == 3 and a.shape[1] == 1 and b.ndim == 3 and b.shape[0] == 1:
        a2, b2 = a[:, 0], b[0]
        return lambda: torch.cdist(a2, b2, compute_mode="donot_use_mm_for_euclid_dist")
    return lambda: F.pairwise_distance(a, b, eps=0.0)


class ParentK7:
    """A parent checkout's ``round_kernels.cu``, built by hand, and its sum
    of squares called as its wrapper called it: where its ``datmo_sumsq``
    takes one operand (7 parameters), the caller's subtraction, then
    ``reshape(-1, k).contiguous()``, the allocation and the launch; else as
    this package calls it.  Its fma (:meth:`fma32`) and ICP's transform
    (:meth:`transform_points`) likewise."""

    def __init__(self, parent: str | Path, dev: torch.device):
        self.lib, text = _build_parent(parent, "round_kernels")
        self.one_operand = c_params(text, "datmo_sumsq") == 7
        self.fn = self.lib.datmo_sumsq
        self.fn.argtypes = ([_P, _P, _I, _I, ctypes.c_int64, _I, _P] if self.one_operand
                            else build._SIGNATURES["datmo_sumsq"][0])
        self.fn.restype = _I
        # an fma of contiguous arrays (10 parameters) before the strided one
        self.fma_flat = c_params(text, "datmo_fma32") == 10
        self.fma = self.lib.datmo_fma32
        self.fma.argtypes = ([_P, _P, _P, _P, _F, _F, _I, ctypes.c_int64, _I, _P]
                             if self.fma_flat else build._SIGNATURES["datmo_fma32"][0])
        self.fma.restype = _I
        self.tp = None
        if "int datmo_transform_points(" in text:
            self.tp = self.lib.datmo_transform_points
            self.tp.argtypes, self.tp.restype = build._SIGNATURES["datmo_transform_points"]
        self.dev = dev

    def fma32(self, a: torch.Tensor, b, c, root: bool) -> torch.Tensor:
        """The parent's fma as its wrapper called it: where it takes
        contiguous arrays, ``torch.broadcast_shapes``, each tensor operand
        ``expand(shape).contiguous()`` (a copy where it broadcasts), the
        allocation and the launch; else as this package calls it."""
        from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

        index = self.dev.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        if not self.fma_flat:
            sig = [(x.shape, x.stride()) if isinstance(x, torch.Tensor) else (None, None)
                   for x in (a, b, c)]
            shape, args = rk._fma32_args(*(v for pair in sig for v in pair), root)
            ptr = [x.data_ptr() if isinstance(x, torch.Tensor) else None for x in (a, b, c)]
            out = torch.empty(shape, dtype=torch.float32, device=self.dev)
            build.check(self.fma(out.data_ptr(), *ptr,
                                 *(0.0 if isinstance(x, torch.Tensor) else float(np.float32(x))
                                   for x in (b, c)), *args, index, stream), "parent")
            return out
        shape = torch.broadcast_shapes(*(x.shape for x in (a, b, c)
                                         if isinstance(x, torch.Tensor)))

        def full(x):
            if not isinstance(x, torch.Tensor):
                return None, float(np.float32(x))
            return x.expand(shape).contiguous(), 0.0

        (af, _), (bf, bs), (cf, cs) = full(a), full(b), full(c)
        out = torch.empty(shape, dtype=torch.float32, device=self.dev)
        build.check(self.fma(out.data_ptr(), af.data_ptr(), None if bf is None else bf.data_ptr(),
                             None if cf is None else cf.data_ptr(), bs, cs, int(root),
                             out.numel(), index, stream), "parent")
        return out

    def transform_points(self, points: torch.Tensor, transformation: torch.Tensor
                         ) -> torch.Tensor:
        """ICP's transform as the parent ran it: four calls (``x * r0``, its
        fma twice, ``+ t``) where it has no ``datmo_transform_points``, else
        its one launch."""
        from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

        if self.tp is None:
            r, t = transformation[:3, :3], transformation[:3, 3]
            x, y, z = (points[:, i:i + 1] for i in range(3))
            acc = x * r[:, 0]
            acc = self.fma32(y, r[:, 1], acc, False)
            acc = self.fma32(z, r[:, 2], acc, False)
            return acc + t
        n, *args = rk._transform_args(points.shape, points.stride(), transformation.shape,
                                      transformation.stride())
        out = torch.empty((n, 3), dtype=torch.float32, device=self.dev)
        build.check(self.tp(out.data_ptr(), points.data_ptr(), transformation.data_ptr(), n,
                            *args, self.dev.index, torch._C._cuda_getCurrentRawStream(
                                self.dev.index)), "parent")
        return out

    def __call__(self, a: torch.Tensor, b: torch.Tensor, root: bool) -> torch.Tensor:
        from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

        stream = torch.cuda.current_stream(self.dev).cuda_stream
        if not self.one_operand:
            out_shape, args = rk._sumsq_args(a.shape, a.stride(), b.shape, b.stride(), root)
            out = torch.empty(out_shape, dtype=torch.float32, device=self.dev)
            build.check(self.fn(out.data_ptr(), a.data_ptr(), b.data_ptr(), *args,
                                self.dev.index, stream), "parent")
            return out
        v = a - b
        k = v.shape[-1]
        rows = v.reshape(-1, k).contiguous()
        out = torch.empty(v.shape[:-1], dtype=torch.float32, device=self.dev)
        build.check(self.fn(out.data_ptr(), rows.data_ptr(), k, int(root), rows.shape[0],
                            self.dev.index, stream), "parent")
        return out


def k7_rows(dev: torch.device, card: str, parent: ParentK7 | None, reps: int = 20,
            rounds: int = 3) -> list:
    """K7's sum of squares of a difference at :data:`K7_SITES` (seeded normal
    operands): held bit for bit to ``sumsq_diff_reference`` (and the
    parent's call too), then per call (CUDA events around each synchronized
    call) and device µs, in turns with the parent (the parent, this build
    twice, the parent) and with :func:`sumsq_library`; medians over
    ``rounds``; each with its bound (``roofline.sumsq_diff``)."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

    gen = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for label, sa, sb, root in K7_SITES:
        a = torch.randn(sa, device=dev, generator=gen) * 20
        b = torch.randn(sb, device=dev, generator=gen) * 20
        want = rk.sumsq_diff_reference(a, b, root)
        call = (lambda a=a, b=b, root=root: rk._sumsq(a, b, root))
        if not rk.bits_equal(call(), want):
            raise AssertionError(f"sumsq {label}: this build differs from the plain version")
        lib = sumsq_library(a, b, root)
        shape = rk._broadcast(a.shape, b.shape)
        n_rows = int(np.prod(shape[:-1]))
        work = roofline.sumsq_diff(a.numel(), b.numel(), n_rows, shape[-1], root)
        fns = {"package": call, "library": lib}
        order = ["package", "library", "library", "package"]
        if parent is not None:
            fns["parent"] = lambda a=a, b=b, root=root: parent(a, b, root)
            if not rk.bits_equal(fns["parent"](), want):
                raise AssertionError(f"sumsq {label}: the parent differs from the plain version")
            order = ["parent", *order, "parent"]
        got = {name: {"ms": [], "us": []} for name in fns}
        for _ in range(rounds):
            for name in order:
                got[name]["ms"].append(ms_per_call(fns[name], dev, reps))
                got[name]["us"].append(device_us_per_call(fns[name], dev))
        med = {name: {k: statistics.median(v) for k, v in d.items()} for name, d in got.items()}
        plain_ms = ms_per_call(lambda: rk.sumsq_diff_reference(a, b, root), dev, 3, 1)
        bound = work.bound_us()
        row = {"name": f"sumsq {label}", "a": list(sa), "b": list(sb), "root": root,
               "bytes": work.bytes, "ops": work.ops, "bound_us": bound,
               "bound_by": work.bound_by(), "plain_ms": plain_ms, "turns": got,
               "ms": med["package"]["ms"], "device_us": med["package"]["us"],
               "share_of_bound": bound / med["package"]["us"],
               "library_ms": med["library"]["ms"], "library_device_us": med["library"]["us"]}
        if parent is not None:
            row.update(parent_ms=med["parent"]["ms"], parent_device_us=med["parent"]["us"])
        print(f"sumsq {label} {tuple(sa)} - {tuple(sb)} root={root}: {row['ms']:.4f} ms/call, "
              f"device {row['device_us']:.1f} us (bound {bound:.3f} us, {work.bound_by()}, share "
              f"{row['share_of_bound']:.3f}); library {row['library_ms']:.4f} ms, device "
              f"{row['library_device_us']:.1f} us"
              + ("" if parent is None else f"; parent {row['parent_ms']:.4f} ms, device "
                 f"{row['parent_device_us']:.1f} us") + f"; plain {plain_ms:.3f} ms [{card}]",
              flush=True)
        rows.append(row)
    return rows


def _fma_site() -> str:
    """``file:line`` of the code that called K7's fma: the first frame
    outside ``ops/round_kernels.py`` and this module."""
    import os
    import sys

    f = sys._getframe(2)
    while os.path.basename(f.f_code.co_filename) in ("round_kernels.py", "micro_flow.py"):
        f = f.f_back
    root = Path(__file__).resolve().parents[2]
    return f"{os.path.relpath(f.f_code.co_filename, root)}:{f.f_lineno}"


def gmfa_fma32_rows(dev: torch.device, card: str, parent: ParentK7 | None = None,
                    reps: int = 20, rounds: int = 3) -> list:
    """K7's fma and ICP's transform at GMFA's sites at reference load
    (``benchmarks/gmfa_reference_load``: its configuration, scene and keys):
    every call of the two wrappers recorded by its call site and operand
    shapes while frames 0 and 1 are preprocessed and one step (cloud 1 after
    ``seed_carry`` of cloud 0) runs; their launches per preprocess and per
    step; then each fma site's first input held bit for bit to
    ``fma32_reference`` and timed in turns (the parent, this build twice, the
    parent, where given) with one ``torch.addcmul`` of the same operands (per
    call, device µs, device records per call: a wrapper's broadcast copies
    included), with its bound (each distinct input read once, the output
    written once; one operation per element).  Then the same at two more
    fma signatures, ICP's former broadcast ``(N, 1) x (3,) + (N, 3)`` (on
    the step's last transform input) and A's 1080x1920 magnitude with its
    root (seeded planes), and ICP's transform on the step's last input
    (:func:`transform_points_row`)."""
    from unittest import mock

    from datmo_using_optical_flow_tpu_torch.benchmarks import gmfa_reference_load as grl
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow_tpu_torch.utils import prng

    cfg = grl.config()
    pipe = GMFAPipeline(cfg, grl.MAX_MOVING, dev)
    frames = grl.raw_frames(cfg, grl.scene(), 2)
    orig, tp_orig = rk._fma32, rk._transform_points
    cases, counts, stage, transforms = {}, {}, ["preprocess"], []

    def record(a, b, c, root):
        key = (_fma_site(), tuple(_sig(x) for x in (a, b, c)), root)
        counts.setdefault(key, {"preprocess": 0, "step": 0})[stage[0]] += 1
        if key not in cases:
            cases[key] = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                               for x in (a, b, c)) + (root,)
        return orig(a, b, c, root)

    def tp_record(points, transformation):
        transforms.append((stage[0], points.clone(), transformation.clone()))
        return tp_orig(points, transformation)

    with mock.patch.object(rk, "_fma32", record), \
            mock.patch.object(rk, "_transform_points", tp_record):
        clouds = grl.clouds(pipe, frames)
        stage[0] = "step"
        carry = pipe.seed_carry(*clouds[0])
        counts_before = {k: dict(v) for k, v in counts.items()}
        seeded = len(transforms)
        pipe.step(*clouds[1], carry, prng.fold_in(prng.PRNGKey(0), 101))
    sync(dev)
    print(f"transform_points: {len(transforms) - seeded} launches per GMFA step, "
          f"{seeded} in seed_carry [{card}]", flush=True)
    _, pts, tr = transforms[-1]
    gen = torch.Generator(device=dev).manual_seed(24)
    vx, vy = (torch.randn((1080, 1920), device=dev, generator=gen) * 5 for _ in range(2))
    extra = {"ICP's former fma32 call, ops/icp.py (parent)":
             (pts[:, 1:2], tr[:3, 1], pts[:, :1] * tr[:3, 0], False),
             "A's magnitude, models/optical_flow_datmo.py:145": (vx, vx, vy * vy, True)}
    extra = {(site, tuple(_sig(x) for x in case[:3]), case[3]): case
             for site, case in extra.items()}
    rows = []
    for key, (a, b, c, root) in [*cases.items(), *extra.items()]:
        site, sig, _ = key
        per_step = counts.get(key, {"step": 0})["step"] - counts_before.get(key, {"step": 0})[
            "step"]
        per_seed = counts_before.get(key, {"step": 0})["step"]
        want = rk.fma32_reference(a, b, c, root)
        call = (lambda a=a, b=b, c=c, root=root: orig(a, b, c, root))
        if not rk.bits_equal(call(), want):
            raise AssertionError(f"fma32 {site}: differs from its plain version")
        tens = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
        values = sum(x.numel() for x in {x.data_ptr(): x for x in tens}.values())
        work = roofline.Work(4 * (values + want.numel()), (1 + int(root)) * want.numel())
        ta, tb, tc = (x if isinstance(x, torch.Tensor) else
                      torch.tensor(float(np.float32(x)), device=dev) for x in (a, b, c))
        fns = {"package": call, "library": lambda ta=ta, tb=tb, tc=tc: torch.addcmul(tc, ta, tb)}
        order = ["package", "library", "library", "package"]
        if parent is not None:
            fns["parent"] = lambda a=a, b=b, c=c, root=root: parent.fma32(a, b, c, root)
            if not rk.bits_equal(fns["parent"](), want):
                raise AssertionError(f"fma32 {site}: the parent differs from the plain version")
            order = ["parent", *order, "parent"]
        t = in_turns(fns, order, dev, reps, rounds)
        us = t["package"]["us_median"]
        row = {"name": f"fma32 {site}", "site": site, "operands": [list(x) if x != "number" else x
                                                                  for x in sig],
               "root": root, "launches_per_preprocess": counts.get(key, {"preprocess": 0})[
                   "preprocess"] / 2,
               "launches_per_seed_carry": per_seed, "launches_per_step": per_step,
               "ms": t["package"]["ms_median"], "device_us": us,
               "records": records_per_call(call, dev) if dev.type == "cuda" else None,
               "bytes": work.bytes, "ops": work.ops, "bound_us": work.bound_us(),
               "bound_by": work.bound_by(),
               "share_of_bound": None if us is None else work.bound_us() / us,
               "library_ms": t["library"]["ms_median"], "library_device_us":
               t["library"]["us_median"], "turns": t,
               "plain_ms": ms_per_call(lambda: rk.fma32_reference(a, b, c, root), dev, 3, 1)}
        if parent is not None:
            row.update(parent_ms=t["parent"]["ms_median"],
                       parent_device_us=t["parent"]["us_median"],
                       parent_records=(records_per_call(fns["parent"], dev)
                                       if dev.type == "cuda" else None))
        rows.append(row)
        print(f"fma32 {site} {sig} root={root}: per preprocess {row['launches_per_preprocess']:g}, "
              f"per step {per_step} launches; {row['ms']:.4f} ms/call, device "
              f"{fmt(us, '.2f')} us, {fmt(row['records'], '.1f')} records (bound "
              f"{work.bound_us():.3f} us, {work.bound_by()}, share "
              f"{fmt(row['share_of_bound'])}); torch.addcmul {row['library_ms']:.4f} ms, device "
              f"{fmt(row['library_device_us'], '.2f')} us"
              + ("" if parent is None else f"; parent {row['parent_ms']:.4f} ms, device "
                 f"{fmt(row['parent_device_us'], '.2f')} us, "
                 f"{fmt(row['parent_records'], '.1f')} records")
              + f"; plain {row['plain_ms']:.3f} ms [{card}]", flush=True)
    rows.append(transform_points_row(pts, tr, dev, card, parent, len(transforms) - seeded,
                                     reps, rounds))
    return rows


def transform_points_row(pts: torch.Tensor, tr: torch.Tensor, dev: torch.device, card: str,
                         parent: ParentK7 | None, per_step: int, reps: int = 20,
                         rounds: int = 3) -> dict:
    """ICP's ``transform_points`` on ``pts`` by ``tr``: held bit for bit to
    its plain version (the parent's too), then per call, device µs and device
    records per call in turns (the parent's four calls, this build's one
    launch, and ``torch.addmm(t, pts, R.T)`` with TF32 off: the same function
    with other bits, a yardstick), with its bound (the points read once, the
    output written once) and the plain version's ms."""
    from datmo_using_optical_flow_tpu_torch.ops import icp as icp_ops

    want = rk.transform_points_reference(pts, tr)
    call = lambda: icp_ops.transform_points(pts, tr)  # noqa: E731
    if not rk.bits_equal(call(), want):
        raise AssertionError("transform_points: differs from its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    r, t = tr[:3, :3].T, tr[:3, 3]
    fns = {"package": call, "library": lambda: torch.addmm(t, pts, r)}
    order = ["package", "library", "library", "package"]
    if parent is not None:
        fns["parent"] = lambda: parent.transform_points(pts, tr)
        if not rk.bits_equal(fns["parent"](), want):
            raise AssertionError("transform_points: the parent differs from the plain version")
        order = ["parent", *order, "parent"]
    tm = in_turns(fns, order, dev, reps, rounds)
    work = roofline.transform_points(pts.shape[0])
    us = tm["package"]["us_median"]
    row = {"name": "transform_points", "points": list(pts.shape), "launches_per_step": per_step,
           "ms": tm["package"]["ms_median"], "device_us": us, "bytes": work.bytes,
           "ops": work.ops, "bound_us": work.bound_us(), "bound_by": work.bound_by(),
           "share_of_bound": None if us is None else work.bound_us() / us,
           "library_ms": tm["library"]["ms_median"],
           "library_device_us": tm["library"]["us_median"], "turns": tm,
           "plain_ms": ms_per_call(lambda: rk.transform_points_reference(pts, tr), dev, 3, 1)}
    for name in fns:
        key = "records" if name == "package" else f"{name}_records"
        row[key] = records_per_call(fns[name], dev) if dev.type == "cuda" else None
    if parent is not None:
        row.update(parent_ms=tm["parent"]["ms_median"], parent_device_us=tm["parent"]["us_median"],
                   parent_share_of_bound=(None if tm["parent"]["us_median"] is None else
                                          work.bound_us() / tm["parent"]["us_median"]))
    print(f"transform_points {tuple(pts.shape)}: {per_step} launches per GMFA step; "
          f"{row['ms']:.4f} ms/call, device {fmt(us, '.2f')} us, {fmt(row['records'], '.1f')} "
          f"records (bound {work.bound_us():.3f} us, {work.bound_by()}, share "
          f"{fmt(row['share_of_bound'])}); torch.addmm {row['library_ms']:.4f} ms, device "
          f"{fmt(row['library_device_us'], '.2f')} us, {fmt(row['library_records'], '.1f')} "
          f"records"
          + ("" if parent is None else f"; parent {row['parent_ms']:.4f} ms, device "
             f"{fmt(row['parent_device_us'], '.2f')} us, {fmt(row['parent_records'], '.1f')} "
             f"records, share {fmt(row['parent_share_of_bound'])}")
          + f"; plain {row['plain_ms']:.3f} ms [{card}]", flush=True)
    return row


def _sig(x) -> tuple | str:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else "number"


def sumsq_path(dev: torch.device, card: str, parent: ParentK7 | None = None,
               n: int = 1000) -> dict:
    """Host µs per call of each part of K7's sum of squares at tracker A's
    site ((4,) - (64, 4), with the root): this package's checks, the
    launch arguments (the broadcast and the strides, cached), the
    allocation, the raw stream lookup and the ctypes call, beside the whole
    call and ``F.pairwise_distance``; with a
    parent of one operand, its parts (the caller's subtraction, the reshape
    and contiguous copy, the allocation, its ctypes call) and its whole call."""
    import torch.nn.functional as F

    from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk

    gen = torch.Generator(device=dev).manual_seed(22)
    a, b = torch.randn(4, device=dev, generator=gen), torch.randn((64, 4), device=dev,
                                                                  generator=gen)
    fn, stream = rk._SUMSQ.resolve()
    index = dev.index
    out = torch.empty(64, dtype=torch.float32, device=dev)
    args = (out.data_ptr(), a.data_ptr(), b.data_ptr(),
            *rk._sumsq_args(a.shape, a.stride(), b.shape, b.stride(), True)[1], index,
            stream(index))
    rec = {"package": host_us({
        "checks (devices, dtypes)": lambda: (fk._on_cuda(a, b), rk._f32(a, "a"),
                                             rk._f32(b, "b")),
        "arguments (cached by shapes and strides)": lambda: rk._sumsq_args(
            a.shape, a.stride(), b.shape, b.stride(), True),
        "allocation (torch.empty)": lambda: torch.empty((64,), dtype=torch.float32, device=dev),
        "raw stream lookup": lambda: stream(index),
        "ctypes call (15 arguments, device guard, launch)": lambda: fn(*args),
        "whole norm_rn(a, b) call": lambda: rk.norm_rn(a, b),
        "F.pairwise_distance": lambda: F.pairwise_distance(a, b, eps=0.0)}, dev, n)}
    if parent is not None and parent.one_operand:
        v = a - b
        rows = v.reshape(-1, 4).contiguous()
        old = (out.data_ptr(), rows.data_ptr(), 4, 1, 64, index, stream(index))
        rec["parent"] = host_us({
            "the caller's subtraction": lambda: a - b,
            "reshape and contiguous": lambda: v.reshape(-1, 4).contiguous(),
            "allocation (torch.empty)": lambda: torch.empty((64,), dtype=torch.float32,
                                                            device=dev),
            "ctypes call (7 arguments, device guard, launch)": lambda: parent.fn(*old),
            "whole call (subtraction, then the sum)": lambda: parent(a, b, True)}, dev, n)
    for who, us in rec.items():
        print(f"sumsq (4,) - (64, 4) launch path ({who}), host us per call over {n} calls: "
              + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + f" [{card}]", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--parent",
                    help="an older checkout whose flow_kernels.cu (level_kernels.cu with --k8) "
                         "to time beside")
    ap.add_argument("--small", action="store_true", help="K1 at the small shapes beside F.conv2d")
    ap.add_argument("--tiny", action="store_true",
                    help="also K4, K2 (Gaussian) and K1 at tiny levels and images")
    ap.add_argument("--k8", action="store_true",
                    help="K8 alone: level images, levels and upsamples of four flows")
    ap.add_argument("--k7", action="store_true",
                    help="K7 alone: its sum of squares at the main paths' sites, its fma and "
                         "ICP's transform at GMFA's")
    ap.add_argument("--k9", action="store_true",
                    help="K9 alone: its scale pass, the warp and a level's packed warp")
    ap.add_argument("--k4", action="store_true",
                    help="the small exact levels as K4 then K2 against the route through K3, "
                         "and K4 alone there and on a sharded block")
    args = ap.parse_args()
    if args.small:
        print(json.dumps(small_levels()))
    elif args.k4:
        resolve_device("cuda")  # raises without a card
        dev = torch.device("cuda", torch.cuda.current_device())
        print(json.dumps(k4_rows(dev, card_label(dev), args.parent)))
    elif args.k9:
        resolve_device("cuda")  # raises without a card
        dev = torch.device("cuda", torch.cuda.current_device())
        card = card_label(dev)
        print(json.dumps({"card": card, "parent": args.parent,
                          "rows": k9_rows(dev, card, args.parent),
                          "launch_path": packed_path(dev, card)}))
    elif args.k7:
        resolve_device("cuda")  # raises without a card
        dev = torch.device("cuda", torch.cuda.current_device())
        card = card_label(dev)
        parent = None if args.parent is None else ParentK7(args.parent, dev)
        print(json.dumps({"card": card, "parent": args.parent,
                          "rows": k7_rows(dev, card, parent),
                          "sumsq_path": sumsq_path(dev, card, parent),
                          "gmfa_fma32": gmfa_fma32_rows(dev, card, parent)}))
    elif args.k8:
        resolve_device("cuda")  # raises without a card
        dev = torch.device("cuda", torch.cuda.current_device())
        card = card_label(dev)
        parent = None if args.parent is None else ParentK8(args.parent, dev)
        print(json.dumps({"card": card, "parent": args.parent,
                          "rows": k8_rows(dev, card, parent),
                          "upsample_path": upsample_path(dev, card, parent)}))
    else:
        print(json.dumps(run(make_frames(2, args.height, args.width), parent=args.parent,
                             tiny=args.tiny)))


if __name__ == "__main__":
    main()
