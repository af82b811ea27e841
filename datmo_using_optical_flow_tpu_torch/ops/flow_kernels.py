"""The flow's CUDA kernels, their plain PyTorch versions and launch counters.

The counterpart of ``datmo_using_optical_flow_tpu.ops.flow_pallas`` and
``ops.warp_pallas``.  Each of :func:`poly_exp` (K1), :func:`blur_solve` (K2),
:func:`fused_iteration` (K3) and :func:`warp_matrices` (K4) dispatches on its
input's device alone: a CPU tensor takes the plain version (``*_reference``),
a CUDA tensor launches the hand-written kernel of ``csrc/flow_kernels.cu`` on
the current stream (through ``kernels/build.Entry``), and any other device
raises.  There is no fallback from a
kernel to its plain version.

``LAUNCHES`` counts kernel launches (not calls of the plain versions), so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import prepare_gaussian

LAUNCHES = {"poly_exp": 0, "blur_solve": 0, "fused_iteration": 0, "warp_matrices": 0}
_POLY_EXP = build.Entry("datmo_poly_exp", "poly_exp")
_BLUR_SOLVE = build.Entry("datmo_blur_solve", "blur_solve")
_FUSED_ITERATION = build.Entry("datmo_fused_iteration", "fused_iteration")
_WARP_MATRICES = build.Entry("datmo_warp_matrices", "warp_matrices")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(t: torch.Tensor, name: str, shape: tuple[int, ...]) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU inputs, True for CUDA inputs on one device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type == "cuda"


@functools.lru_cache(maxsize=8)
def _poly_taps(n: int, sigma: float) -> tuple[np.ndarray, ...]:
    """float32 (g, xg, xxg, [ig11, ig03, ig33, ig55]) for the kernel."""
    g, xg, xxg, invG = prepare_gaussian(n, sigma)
    igs = [invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]]
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in (g, xg, xxg, igs))


def poly_exp_compiled(n: int, sigma: float) -> bool:
    """Whether ``datmo_poly_exp`` runs K1's compile-time instance for these
    taps (the rule of ``csrc/flow_kernels.cu::poly_taps_structural``): poly_n
    5 or 7, every g tap nonzero in float32, xg and xxg zero exactly at the
    centre.  Other taps (a small sigma whose tails underflow) take the
    runtime-n kernel."""
    g, xg, xxg, _ = _poly_taps(n, float(sigma))
    centre = np.arange(2 * n + 1) == n
    return n in (5, 7) and bool((g != 0).all() and ((xg == 0) == centre).all()
                                and ((xxg == 0) == centre).all())


@functools.lru_cache(maxsize=8)
def _window(winsize: int, gaussian: bool) -> tuple[np.ndarray, float]:
    """float32 window taps and the post-sum scale (1/win² for the box)."""
    if gaussian:
        return fb.gauss_window(winsize), 1.0
    return np.ones(winsize, np.float32), float(np.float32(1.0 / (winsize * winsize)))


def _check_window(winsize: int) -> None:
    if winsize < 3 or winsize % 2 == 0 or winsize > 63:
        raise ValueError(f"winsize must be odd in [3, 63], got {winsize}")


# ------------------------------------------------------------------ K1

def poly_exp_reference(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Plain version of K1: the polynomial expansion (5, H, W) by separable
    shift-and-add correlations, in the tap order and with the skip rules of
    the JAX package's ``ops.farneback.poly_exp``."""
    g, xg, xxg, invG = prepare_gaussian(n, sigma)
    ig11, ig03, ig33, ig55 = (float(np.float32(invG[i, j]))
                              for i, j in ((1, 1), (0, 3), (3, 3), (5, 5)))
    h, _ = img.shape
    pv = fb._pad_axis(img, n, -2, "edge")
    row_g = row_xg = row_xxg = None
    for i in range(2 * n + 1):
        sl = pv[i:i + h]
        tg = float(np.float32(g[i])) * sl
        row_g = tg if row_g is None else row_g + tg
        if xg[i] != 0.0:  # xg's zero centre tap is skipped, xxg's is kept
            t = float(np.float32(xg[i])) * sl
            row_xg = t if row_xg is None else row_xg + t
        t2 = float(np.float32(xxg[i])) * sl
        row_xxg = t2 if row_xxg is None else row_xxg + t2

    def corr_x(a, kern):
        return fb._corr_axis(a, kern.astype(np.float32), -1, "edge")

    b1 = corr_x(row_g, g)
    b2 = corr_x(row_g, xg)
    b3 = corr_x(row_xg, g)
    b4 = corr_x(row_g, xxg)
    b5 = corr_x(row_xxg, g)
    b6 = corr_x(row_xg, xg)
    return torch.stack([
        b3 * ig11,                 # y-linear
        b2 * ig11,                 # x-linear
        b1 * ig03 + b5 * ig33,     # y^2
        b1 * ig03 + b4 * ig33,     # x^2
        b6 * ig55,                 # xy
    ])


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """K1: polynomial expansion of a float32 (H, W) image -> (5, H, W)."""
    if img.ndim != 2:
        raise ValueError(f"img: expected (H, W), got {tuple(img.shape)}")
    h, w = img.shape
    _check(img, "img", (h, w))
    if not _on_cuda(img):
        return poly_exp_reference(img, n, sigma)
    g, xg, xxg, igs = _poly_taps(n, float(sigma))
    out = torch.empty((5, h, w), dtype=torch.float32, device=img.device)
    _POLY_EXP(img.device.index, out.data_ptr(), img.data_ptr(), h, w, n, g.ctypes.data,
              xg.ctypes.data, xxg.ctypes.data, igs.ctypes.data)
    LAUNCHES["poly_exp"] += 1
    return out


# ------------------------------------------------------------------ K2

def blur_solve_reference(M: torch.Tensor, winsize: int, gaussian: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``solve_flow(box_blur5 or gauss_blur5 (M))``."""
    blur = fb.gauss_blur5 if gaussian else fb.box_blur5
    return fb.solve_flow(blur(M, winsize))


def blur_solve(M: torch.Tensor, winsize: int, gaussian: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: window aggregation of M (5, H, W) and the 2x2 solve -> (dx, dy)."""
    if M.ndim != 3 or M.shape[0] != 5:
        raise ValueError(f"M: expected (5, H, W), got {tuple(M.shape)}")
    _, h, w = M.shape
    _check(M, "M", (5, h, w))
    _check_window(winsize)
    if not _on_cuda(M):
        return blur_solve_reference(M, winsize, gaussian)
    taps, scale = _window(winsize, gaussian)
    dx = torch.empty((h, w), dtype=torch.float32, device=M.device)
    dy = torch.empty_like(dx)
    _BLUR_SOLVE(M.device.index, dx.data_ptr(), dy.data_ptr(), M.data_ptr(), h, w,
                taps.ctypes.data, winsize, scale)
    LAUNCHES["blur_solve"] += 1
    return dx, dy


# ------------------------------------------------------------------ K3

def fused_iteration_reference(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor,
                              dy: torch.Tensor, winsize: int, gaussian: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: K4's plain version then K2's."""
    return blur_solve_reference(warp_matrices_reference(R0, R1, dx, dy), winsize, gaussian)


def _check_planes_and_flow(R0, R1, dx, dy) -> tuple[int, int]:
    if R0.ndim != 3 or R0.shape[0] != 5:
        raise ValueError(f"R0: expected (5, H, W), got {tuple(R0.shape)}")
    _, h, w = R0.shape
    for t, name, shape in ((R0, "R0", (5, h, w)), (R1, "R1", (5, h, w)),
                           (dx, "dx", (h, w)), (dy, "dy", (h, w))):
        _check(t, name, shape)
    return h, w


def fused_iteration(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor,
                    dy: torch.Tensor, winsize: int, gaussian: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: one refinement iteration (warp R1 by the flow, assemble M, window
    sum, solve) -> new (dx, dy).  R0, R1 are (5, H, W), dx, dy (H, W); unlike
    the JAX kernel, R1 is not padded: the warp gathers any displacement."""
    h, w = _check_planes_and_flow(R0, R1, dx, dy)
    _check_window(winsize)
    if not _on_cuda(R0, R1, dx, dy):
        return fused_iteration_reference(R0, R1, dx, dy, winsize, gaussian)
    taps, scale = _window(winsize, gaussian)
    odx = torch.empty((h, w), dtype=torch.float32, device=R0.device)
    ody = torch.empty_like(odx)
    _FUSED_ITERATION(R0.device.index, odx.data_ptr(), ody.data_ptr(), R0.data_ptr(),
                     R1.data_ptr(), dx.data_ptr(), dy.data_ptr(), h, w, taps.ctypes.data,
                     winsize, scale)
    LAUNCHES["fused_iteration"] += 1
    return odx, ody


# ------------------------------------------------------------------ K4

def warp_matrices_reference(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor,
                            dy: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the exact (unpacked) ``update_matrices``."""
    return fb.update_matrices(R0, R1, dx, dy)


def warp_matrices(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor,
                  dy: torch.Tensor) -> torch.Tensor:
    """K4: warp R1 by the flow and assemble the normal-equation planes
    M (5, H, W).  As for K3, R1 is not padded: the warp gathers any
    displacement (the JAX kernel takes ``_pad_r1``'s window layout and only
    the displacements that window reaches)."""
    h, w = _check_planes_and_flow(R0, R1, dx, dy)
    if not _on_cuda(R0, R1, dx, dy):
        return warp_matrices_reference(R0, R1, dx, dy)
    M = torch.empty((5, h, w), dtype=torch.float32, device=R0.device)
    _WARP_MATRICES(R0.device.index, M.data_ptr(), R0.data_ptr(), R1.data_ptr(), dx.data_ptr(),
                   dy.data_ptr(), h, w)
    LAUNCHES["warp_matrices"] += 1
    return M
