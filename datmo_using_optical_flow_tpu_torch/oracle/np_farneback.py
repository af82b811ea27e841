"""Numpy model of OpenCV's Farnebäck dense optical flow (cv2 semantics).

A verbatim copy of ``datmo_using_optical_flow_tpu.oracle.np_farneback``: the
constants and helpers the port's flow uses, and the whole numpy flow
(``gaussian_blur`` ... ``calc_flow``), which the JAX package's tests pin to
``cv2.calcOpticalFlowFarneback`` at < 1e-3 px EPE.  It needs numpy alone, so
it is the cv2-exact flow on a machine without cv2 (the port's benchmarks take
their EPE against it).  The port cannot import the JAX package (its
``__init__`` imports yaml); ``tests/test_torch_boundary.py`` holds every
function here to its original line for line.

Algorithm stages (Farnebäck 2003 + OpenCV optflowgf semantics):
  1. per-level image prep: GaussianBlur(sigma=(1/scale-1)/2) then bilinear resize;
  2. polynomial expansion: 6-basis weighted LSQ fit via separable correlations;
  3. update matrices: flow-compensated coefficient averaging + border attenuation;
  4. flow update: box-blur (winsize) of the 5 normal-equation planes + 2x2 solve;
  5. coarse-to-fine: upsample flow x(1/pyr_scale) between levels.
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


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with BORDER_REFLECT_101 (cv2.GaussianBlur default)."""
    k = gaussian_kernel(ksize, sigma).astype(np.float32)
    r = ksize // 2
    if r == 0:
        return img.astype(np.float32)
    p = np.pad(img.astype(np.float32), r, mode="reflect")  # reflect101
    # vertical then horizontal
    out = np.zeros_like(p)
    for i, w in enumerate(k):
        out[r:-r or None, :] += w * p[i:i + p.shape[0] - 2 * r, :]
    p2 = out
    out2 = np.zeros_like(img, dtype=np.float32)
    for i, w in enumerate(k):
        out2 += w * p2[r:-r or None, i:i + img.shape[1]]
    return out2


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize INTER_LINEAR for float images (pixel-center convention)."""
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.astype(np.float32)
    sy = h / out_h
    sx = w / out_w
    fy = (np.arange(out_h) + 0.5) * sy - 0.5
    fx = (np.arange(out_w) + 0.5) * sx - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 2) if h > 1 else np.zeros(out_h, int)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 2) if w > 1 else np.zeros(out_w, int)
    wy = np.clip(fy - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(fx - x0, 0.0, 1.0).astype(np.float32)
    if h == 1:
        wy = np.zeros(out_h, np.float32)
    if w == 1:
        wx = np.zeros(out_w, np.float32)
    img = img.astype(np.float32)
    a = img[y0][:, x0]
    b = img[y0][:, np.minimum(x0 + 1, w - 1)]
    c = img[np.minimum(y0 + 1, h - 1)][:, x0]
    d = img[np.minimum(y0 + 1, h - 1)][:, np.minimum(x0 + 1, w - 1)]
    wy = wy[:, None]
    wx = wx[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    return ((a * (1 - wx) + b * wx) * (1 - wy) + (c * (1 - wx) + d * wx) * wy)


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


def poly_exp(img: np.ndarray, n: int, sigma: float, use_ig34: bool = False) -> np.ndarray:
    """Polynomial expansion -> (H, W, 5) planes [b_y, b_x, c_yy?, c_xx?, c_xy].

    Channel order/terms follow OpenCV (validated empirically): ch0 = y-linear,
    ch1 = x-linear, ch2/ch3 = quadratic diag terms, ch4 = cross term.
    """
    g, xg, xxg, invG = prepare_gaussian(n, sigma)
    ig11, ig03, ig33, ig55 = invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]
    ig34 = invG[3, 4]
    img = img.astype(np.float32)
    h, w = img.shape
    # vertical pass (border replicate): channels (g*f, xg*f, xxg*f)
    pv = np.pad(img, ((n, n), (0, 0)), mode="edge").astype(np.float64)
    row_g = np.zeros((h, w))
    row_xg = np.zeros((h, w))
    row_xxg = np.zeros((h, w))
    for k in range(-n, n + 1):
        sl = pv[k + n:k + n + h]
        row_g += g[k + n] * sl
        row_xg += xg[k + n] * sl
        row_xxg += xxg[k + n] * sl
    # horizontal pass (border replicate on the smoothed rows)
    def corr_x(a, kern):
        pa = np.pad(a, ((0, 0), (n, n)), mode="edge")
        out = np.zeros_like(a)
        for k in range(-n, n + 1):
            out += kern[k + n] * pa[:, k + n:k + n + w]
        return out

    b1 = corr_x(row_g, g)
    b2 = corr_x(row_g, xg)
    b3 = corr_x(row_xg, g)
    b4 = corr_x(row_g, xxg)
    b5 = corr_x(row_xxg, g)
    b6 = corr_x(row_xg, xg)

    R = np.zeros((h, w, 5), dtype=np.float32)
    R[..., 0] = b3 * ig11          # y-linear
    R[..., 1] = b2 * ig11          # x-linear
    if use_ig34:
        R[..., 2] = b1 * ig03 + b5 * ig33 + b4 * ig34  # y^2
        R[..., 3] = b1 * ig03 + b4 * ig33 + b5 * ig34  # x^2
    else:
        R[..., 2] = b1 * ig03 + b5 * ig33
        R[..., 3] = b1 * ig03 + b4 * ig33
    R[..., 4] = b6 * ig55          # xy
    return R


def update_matrices(R0: np.ndarray, R1: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Flow-compensated normal-equation planes M (H, W, 5)."""
    h, w = flow.shape[:2]
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    dx = flow[..., 0]
    dy = flow[..., 1]
    fx = xs + dx
    fy = ys + dy
    x1 = np.floor(fx).astype(int)
    y1 = np.floor(fy).astype(int)
    fx = fx - x1
    fy = fy - y1
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    x1c = np.clip(x1, 0, w - 2 if w > 1 else 0)
    y1c = np.clip(y1, 0, h - 2 if h > 1 else 0)
    a00 = (1 - fx) * (1 - fy)
    a01 = fx * (1 - fy)
    a10 = (1 - fx) * fy
    a11 = fx * fy
    r = (a00[..., None] * R1[y1c, x1c] + a01[..., None] * R1[y1c, x1c + 1]
         + a10[..., None] * R1[y1c + 1, x1c] + a11[..., None] * R1[y1c + 1, x1c + 1])
    ins = inside[..., None]
    r2 = np.where(inside, r[..., 0], 0.0)
    r3 = np.where(inside, r[..., 1], 0.0)
    r4 = np.where(inside, (R0[..., 2] + r[..., 2]) * 0.5, R0[..., 2])
    r5 = np.where(inside, (R0[..., 3] + r[..., 3]) * 0.5, R0[..., 3])
    r6 = np.where(inside, (R0[..., 4] + r[..., 4]) * 0.25, R0[..., 4] * 0.5)
    del ins
    r2 = (R0[..., 0] - r2) * 0.5
    r3 = (R0[..., 1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    # border attenuation
    scale = np.ones((h, w), dtype=np.float64)
    for axis, size in ((0, h), (1, w)):
        idx = ys if axis == 0 else xs
        near = np.minimum(idx, size - 1 - idx)
        s = np.where(near < BORDER, BORDER_ATTEN[np.minimum(near, BORDER - 1)], 1.0)
        scale = scale * s
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))

    M = np.zeros((h, w, 5), dtype=np.float32)
    M[..., 0] = r4 * r4 + r6 * r6
    M[..., 1] = (r4 + r5) * r6
    M[..., 2] = r5 * r5 + r6 * r6
    M[..., 3] = r4 * r2 + r6 * r3
    M[..., 4] = r6 * r2 + r5 * r3
    return M


def gauss_blur5(M: np.ndarray, winsize: int) -> np.ndarray:
    """OPTFLOW_FARNEBACK_GAUSSIAN aggregation: separable normalized Gaussian
    (sigma = (winsize//2)*0.3), BORDER_REPLICATE (validated vs cv2 flags=256)."""
    m = winsize // 2
    x = np.arange(-m, m + 1, dtype=np.float64)
    sigma = m * 0.3
    g = np.exp(-x * x / (2 * sigma * sigma))
    g /= g.sum()
    p = np.pad(M.astype(np.float64), ((m, m), (m, m), (0, 0)), mode="edge")
    tmp = np.zeros((M.shape[0], p.shape[1], 5))
    for i, wgt in enumerate(g):
        tmp += wgt * p[i:i + M.shape[0]]
    out = np.zeros_like(M, dtype=np.float64)
    for i, wgt in enumerate(g):
        out += wgt * tmp[:, i:i + M.shape[1]]
    return out


def box_blur5(M: np.ndarray, winsize: int) -> np.ndarray:
    """Normalized box filter with BORDER_REPLICATE, double accumulation."""
    m = winsize // 2
    p = np.pad(M.astype(np.float64), ((m, m), (m, m), (0, 0)), mode="edge")
    c = np.cumsum(np.cumsum(p, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    h, w = M.shape[:2]
    s = (c[winsize:winsize + h, winsize:winsize + w]
         - c[winsize:winsize + h, :w]
         - c[:h, winsize:winsize + w]
         + c[:h, :w])
    return s / (winsize * winsize)


def solve_flow(Mb: np.ndarray) -> np.ndarray:
    """Per-pixel 2x2 solve with OpenCV's +1e-3 determinant regularizer."""
    g11 = Mb[..., 0]
    g12 = Mb[..., 1]
    g22 = Mb[..., 2]
    h1 = Mb[..., 3]
    h2 = Mb[..., 4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    flow = np.zeros(Mb.shape[:2] + (2,), dtype=np.float32)
    flow[..., 0] = (g11 * h2 - g12 * h1) * idet
    flow[..., 1] = (g22 * h1 - g12 * h2) * idet
    return flow


def farneback_level(R0, R1, flow, winsize, iterations, gaussian: bool = False):
    blur = gauss_blur5 if gaussian else box_blur5
    M = update_matrices(R0, R1, flow)
    for i in range(iterations):
        flow = solve_flow(blur(M, winsize).astype(np.float32))
        if i < iterations - 1:
            M = update_matrices(R0, R1, flow)
    return flow


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


def calc_flow(im1: np.ndarray, im2: np.ndarray, pyr_scale=0.3, levels=5, winsize=15,
              iterations=5, poly_n=5, poly_sigma=5.0, flow0=None,
              gaussian: bool = False) -> np.ndarray:
    """Full pyramidal Farnebäck flow (box or Gaussian aggregation; optional
    OPTFLOW_USE_INITIAL_FLOW via ``flow0``)."""
    h, w = im1.shape
    prev_flow = None
    flow = None
    for k, scale, lh, lw in level_sizes(h, w, pyr_scale, levels):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        if prev_flow is None:
            if flow0 is not None:
                flow = resize_bilinear(flow0, lh, lw) * scale
            else:
                flow = np.zeros((lh, lw, 2), dtype=np.float32)
        else:
            flow = resize_bilinear(prev_flow, lh, lw) * (1.0 / pyr_scale)
        Rs = []
        for im in (im1, im2):
            f = gaussian_blur(im.astype(np.float32), smooth_sz, sigma)
            f = resize_bilinear(f, lh, lw)
            Rs.append(poly_exp(f, poly_n, poly_sigma))
        flow = farneback_level(Rs[0], Rs[1], flow, winsize, iterations, gaussian)
        prev_flow = flow
    return flow
