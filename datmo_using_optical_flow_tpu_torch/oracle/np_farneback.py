"""Numpy constants and helpers of the Farnebäck flow (cv2 semantics).

A copy of the parts of ``datmo_using_optical_flow_tpu.oracle.np_farneback`` that
the port's flow needs; the port cannot import that package (its ``__init__``
imports yaml).  ``tests/test_torch_boundary.py`` holds the copies equal to the
originals.
"""

from __future__ import annotations

import numpy as np

BORDER_ATTEN = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)
BORDER = 5
MIN_LEVEL_SIZE = 32

_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (incl. the fixed small-kernel table)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].astype(np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def prepare_gaussian(n: int, sigma: float):
    """Polyexp applicability kernel + the needed inverse-Gram entries (float64)."""
    if sigma < 1e-7:  # OpenCV FarnebackPolyExp: sigma defaults to n*0.3 when tiny
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    # Gram matrix over basis (1, x, y, x^2, y^2, xy) with weights g(x)g(y)
    G = np.zeros((6, 6), dtype=np.float64)
    for yy in range(-n, n + 1):
        for xx in range(-n, n + 1):
            w = g[yy + n] * g[xx + n]
            G[0, 0] += w
            G[1, 1] += w * xx * xx
            G[2, 2] += w * yy * yy
            G[3, 3] += w * xx ** 4
            G[4, 4] += w * yy ** 4
            G[5, 5] += w * xx * xx * yy * yy
            G[0, 3] += w * xx * xx
            G[0, 4] += w * yy * yy
            G[3, 4] += w * xx * xx * yy * yy
    G[3, 0] = G[0, 3]
    G[4, 0] = G[0, 4]
    G[4, 3] = G[3, 4]
    invG = np.linalg.inv(G)
    return g, xg, xxg, invG


def level_sizes(h: int, w: int, pyr_scale: float, levels: int):
    """OpenCV level schedule: clamp levels so min dim stays >= 32."""
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < MIN_LEVEL_SIZE or h * scale < MIN_LEVEL_SIZE:
            break
        k += 1
    top = k
    out = []
    for k in range(top, -1, -1):
        scale = pyr_scale ** k
        out.append((k, scale, int(round(h * scale)), int(round(w * scale))))
    return out
