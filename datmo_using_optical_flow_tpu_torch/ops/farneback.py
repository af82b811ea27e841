"""Pyramidal Farnebäck dense optical flow in PyTorch.

The counterpart of ``datmo_using_optical_flow_tpu.ops.farneback`` (cv2
``calcOpticalFlowFarneback`` semantics): the same channel-first ``(5, H, W)``
plane layouts, the same tap order and float32 casts, the same level schedule.
The three hot stages go through the CUDA kernels of
:mod:`~datmo_using_optical_flow_tpu_torch.ops.flow_kernels` (polynomial
expansion; the fused warp + window + solve iteration; window + solve), and the
pyramid's level images and the flow's upsample through K8
(:mod:`~datmo_using_optical_flow_tpu_torch.ops.level_kernels`), whose plain
versions run for CPU tensors.  The level images and the resize round as the
JAX package's jitted step rounds them (each product contracted into the add
that takes it), so the pyramid equals its jitted ``build_pyramid(...,
use_pallas=False)`` bit for bit.

No host synchronisation on the step's path: index and weight tables are built
on the tensor's device from Python scalars, never copied from the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import (
    BORDER,
    BORDER_ATTEN,
    gaussian_kernel,
    level_sizes,
)
from datmo_using_optical_flow_tpu_torch.ops import warp

OPTFLOW_USE_INITIAL_FLOW = 4     # cv2 flag values
OPTFLOW_FARNEBACK_GAUSSIAN = 256

# jnp.pad mode -> F.pad mode ("reflect" is reflect-101 in both)
_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


# ------------------------------------------------------------------ primitives

def _pad_axis(x: torch.Tensor, n: int, axis: int, mode: str) -> torch.Tensor:
    """Pad one of the last two axes by ``n`` on both sides (``jnp.pad`` modes).

    F.pad's replicate/reflect modes pad the last two dims of a 4-D input, so
    the leading axes are folded into one around the call."""
    axis = axis % x.ndim
    if x.ndim < 2 or axis < x.ndim - 2:
        raise ValueError(f"can pad only the last two axes, got axis {axis} of {x.ndim}-D")
    pads = (n, n, 0, 0) if axis == x.ndim - 1 else (0, 0, n, n)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    p = F.pad(x.reshape(1, -1, h, w), pads, mode=_PAD_MODES[mode])
    return p.reshape(*lead, *p.shape[-2:])


def _corr_axis(img: torch.Tensor, kernel: np.ndarray, axis: int,
               pad_mode: str = "edge") -> torch.Tensor:
    """1-D correlation along ``axis`` by shift-and-add, taps in ascending order;
    taps that are zero in float32 are skipped.  Each product and each add is
    rounded on its own: the form of the window sums, which K2 and K3 equal
    bit for bit (the level images' blur takes the contracted form,
    :func:`_corr_at`)."""
    k = np.asarray(kernel, dtype=np.float32)
    n = len(k) // 2
    size = img.shape[axis]
    p = _pad_axis(img, n, axis, pad_mode)
    out = None
    for i, w in enumerate(k):
        if w == 0.0:
            continue
        term = float(w) * p.narrow(axis, i, size)
        out = term if out is None else out + term
    return out


def sep_filter(img: torch.Tensor, ky: np.ndarray, kx: np.ndarray, pad_mode: str) -> torch.Tensor:
    """Separable 2-D filter over the last two axes."""
    return _corr_axis(_corr_axis(img, ky, -2, pad_mode), kx, -1, pad_mode)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur (BORDER_REFLECT_101) of a float32 (H, W) image, as
    the JAX package's jitted ``gaussian_blur`` rounds it: the K8 kernel on
    the card (:mod:`.level_kernels`), :func:`gaussian_blur_reference` on the
    CPU."""
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels

    return level_kernels.blur(img, ksize, sigma)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    scale: float = 1.0) -> torch.Tensor:
    """cv2.resize INTER_LINEAR (pixel-centre convention) of a float32
    (..., H, W) over its last two axes, times the float32 ``scale`` (1.0:
    no multiply), as the JAX package's jitted ``resize_bilinear(...) *
    scale`` rounds it: the K8 kernel on the card, :func:`resize_bilinear_reference`
    on the CPU."""
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels

    return level_kernels.resize(img, out_h, out_w, scale)


# ------------------------------------------------------------------ K8's plain versions

def reflect101(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Positions ``idx`` mapped into ``[0, size)`` as ``jnp.pad(mode="reflect")``
    pads (reflect-101, repeated where the pad reaches past the axis, as
    numpy repeats it); an axis of length 1 pads with its one value."""
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    m = torch.remainder(idx, period)
    return torch.where(m >= size, period - m, m)


@functools.lru_cache(maxsize=64)
def resize_table(size: int, out: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2 INTER_LINEAR sampling of one axis, built once per ``(size, out,
    device)``: ``(i0, i1, w, 1 - w)``, the two source positions (int64) and
    the float32 weights of ``i1`` and ``i0``; shared by every caller, and
    read, never written.

    The positions are computed in float64 on ``device`` with the same
    operations as the JAX package's numpy tables, so they are bit-identical
    to them; ``1 - w`` is the float32 subtraction XLA folds."""
    f = (torch.arange(out, dtype=torch.float64, device=device) + 0.5) * (size / out) - 0.5
    i0 = torch.clamp(torch.floor(f), 0, max(size - 2, 0))
    wgt = torch.clamp(f - i0, 0.0, 1.0).to(torch.float32)
    if size <= 1:
        wgt = torch.zeros_like(wgt)
    i0 = i0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=size - 1), wgt, 1 - wgt


def _lerp(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a * (1 - w) + b * w`` contracted as XLA's CPU code does it:
    ``fma(a, 1 - w, b * w)``, the product ``b * w`` rounded on its own."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    return round_kernels.fma32_reference(a, v, b * w)


def blur_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2's float32 Gaussian taps of the pre-blur."""
    return gaussian_kernel(ksize, sigma).astype(np.float32)


def _corr_at(img: torch.Tensor, taps: np.ndarray, axis: int,
             at: torch.Tensor | None = None) -> torch.Tensor:
    """The 1-D correlation along ``axis`` (-2 or -1) with reflect-101
    padding, at the positions ``at`` of that axis (every position when
    None): a chain of once-rounded fmas in ascending tap order, zero taps
    skipped (:func:`.round_kernels.fma_chain_reference`), as XLA's compiled
    ``_corr_axis`` rounds the blur.  On an axis of length 1 every tap reads
    the one value, and XLA computes the product of taps of equal weight
    once: such products are rounded on their own and added."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    n, size = len(taps) // 2, img.shape[axis]
    pos = torch.arange(size, device=img.device) if at is None else at
    if size == 1:
        ws = [float(w) for w in taps if w != 0.0]
        x = img.index_select(axis, torch.zeros_like(pos))
        return round_kernels.fma_chain_reference(
            [(i, w, x) for i, w in enumerate(ws)],
            frozenset(i for i, w in enumerate(ws) if ws.count(w) > 1))
    return round_kernels.fma_chain_reference(
        [(i, w, img.index_select(axis, reflect101(pos + (i - n), size)))
         for i, w in enumerate(taps) if w != 0.0])


def gaussian_blur_reference(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Plain version of K8's blur: the vertical pass, then the horizontal one,
    over the last two axes."""
    taps = blur_taps(ksize, sigma)
    if len(taps) == 1:
        return img
    return _corr_at(_corr_at(img, taps, -2), taps, -1)


def resize_bilinear_reference(img: torch.Tensor, out_h: int, out_w: int,
                              scale: float = 1.0) -> torch.Tensor:
    """Plain version of K8's resize: the rows' lerp, then the columns', each
    ``fma(a, 1 - w, b * w)``, then the multiply by ``scale`` unless it is 1."""
    h, w = img.shape[-2], img.shape[-1]
    if (out_h, out_w) != (h, w):
        y0, y1, wy, vy = resize_table(h, out_h, img.device)
        x0, x1, wx, vx = resize_table(w, out_w, img.device)
        v = _lerp(img.index_select(-2, y0), img.index_select(-2, y1), wy[:, None], vy[:, None])
        img = _lerp(v.index_select(-1, x0), v.index_select(-1, x1), wx, vx)
    scale = float(np.float32(scale))
    return img if scale == 1.0 else img * scale


def level_blur(scale: float) -> tuple[int, float]:
    """cv2's pre-blur of the pyramid level at ``scale``: (ksize, sigma)."""
    sigma = (1.0 / scale - 1.0) * 0.5
    return max(int(round(sigma * 5)) | 1, 3), sigma


def level_image_reference(im: torch.Tensor, scale: float, lh: int, lw: int) -> torch.Tensor:
    """Plain version of K8's level image: :func:`gaussian_blur_reference`
    then :func:`resize_bilinear_reference` of a float32 (H, W) image,
    evaluating the blur only where the resize reads it: the vertical pass at
    the rows each output row's ``i0`` and ``i1`` name, the horizontal pass at
    the columns each output column's ``i0`` and ``i1`` name.  Each value is
    the same chain as in the full blur, so the bits are the same."""
    ksize, sigma = level_blur(scale)
    h, w = im.shape
    if (lh, lw) == (h, w):
        return gaussian_blur_reference(im, ksize, sigma)
    taps = blur_taps(ksize, sigma)
    y0, y1, wy, vy = resize_table(h, lh, im.device)
    x0, x1, wx, vx = resize_table(w, lw, im.device)
    rows = [_corr_at(im, taps, -2, y) for y in (y0, y1)]              # (lh, W) each
    (a0, a1), (b0, b1) = ([_corr_at(r, taps, -1, x) for x in (x0, x1)] for r in rows)
    wy, vy = wy[:, None], vy[:, None]
    return _lerp(_lerp(a0, b0, wy, vy), _lerp(a1, b1, wy, vy), wx, vx)


# ------------------------------------------------------------------ poly expansion

def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Quadratic polynomial expansion -> (5, H, W) planes
    [y-linear, x-linear, y², x², xy].

    A CUDA tensor takes the K1 kernel at every size; a CPU tensor takes its
    plain version.  (The JAX package splits by size because its strip kernel
    does not pay off below 256x256; both of its branches compute this same
    function, to ~1 ulp.)"""
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels

    return flow_kernels.poly_exp(img, n, sigma)


# ------------------------------------------------------------------ matrices / solve

def border_axis(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Certainty attenuation, float32, of positions ``idx`` along an axis of
    ``size``: BORDER_ATTEN within BORDER=5 positions of either end, else 1."""
    near = torch.minimum(idx, size - 1 - idx)
    out = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    for k in range(BORDER):
        out = torch.where(near == k, float(BORDER_ATTEN[k]), out)
    return out


def _border_scale(h: int, w: int, device) -> torch.Tensor:
    """Certainty attenuation within BORDER=5 pixels of each edge, float32."""
    return (border_axis(torch.arange(h, device=device), h)[:, None]
            * border_axis(torch.arange(w, device=device), w)[None, :])


def pack_corner_pairs(R1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize all four bilinear corners of all five planes into 7 int32 words
    per grid position (the JAX package's packed table, bit for bit).

    * words 0-1: channel 0 corners (A,B) / (C,D) as int16 pairs
    * words 2-3: channel 1 likewise
    * words 4-6: channels 2-4, all four corners as int8 bytes

    Corners: A = R1(y,x), B = (y,x+1), C = (y+1,x), D = (y+1,x+1),
    edge-replicated.  Returns ``(table (H*W, 7) int32, scale (5,))``; JAX keeps
    the same bits in a float32-typed table.
    """
    _, h, w = R1.shape
    right = torch.cat([R1[:, :, 1:], R1[:, :, -1:]], dim=2)
    down = torch.cat([R1[:, 1:, :], R1[:, -1:, :]], dim=1)
    downright = torch.cat([right[:, 1:, :], right[:, -1:, :]], dim=1)
    corners = torch.stack([R1, right, down, downright])  # (4, 5, H, W)

    absmax = torch.amax(torch.abs(R1), dim=(1, 2))  # (5,)
    qmax = torch.where(torch.arange(5, device=R1.device) < 2, 32767.0, 127.0)
    scale = torch.clamp(absmax, min=1e-20) / qmax
    qb = qmax[None, :, None, None]
    q = torch.clamp(torch.round(corners / scale[None, :, None, None]), -qb, qb)
    qi = q.to(torch.int64)
    u16 = qi & 0xFFFF  # two's complement bits of the int16 value
    u8 = qi & 0xFF     # ... of the int8 value

    words = [
        (u16[0, 0] << 16) | u16[1, 0],            # ch0: A|B
        (u16[2, 0] << 16) | u16[3, 0],            # ch0: C|D
        (u16[0, 1] << 16) | u16[1, 1],            # ch1: A|B
        (u16[2, 1] << 16) | u16[3, 1],            # ch1: C|D
    ]
    for ch in (2, 3, 4):
        words.append((u8[0, ch] << 24) | (u8[1, ch] << 16) | (u8[2, ch] << 8) | u8[3, ch])
    table = torch.stack(words, dim=-1)  # (H, W, 7) uint32 values held in int64
    table = torch.where(table >= 2 ** 31, table - 2 ** 32, table).to(torch.int32)
    return table.reshape(h * w, 7), scale


def _unpack_warp(g: torch.Tensor, scale: torch.Tensor, a00, a01, a10, a11):
    """Bilinear-combine the packed corners: (N, 7) rows -> list of 5 (N,) values."""
    def signed(v, bits):
        return (v - ((v >> (bits - 1)) << bits)).to(torch.float32)

    def i16(word, hi):
        return signed((word >> 16 if hi else word) & 0xFFFF, 16)

    def i8(word, byte):
        return signed((word >> (24 - 8 * byte)) & 0xFF, 8)

    out = []
    for ch, (wa, wb) in enumerate(((0, 1), (2, 3))):
        r = (a00 * i16(g[:, wa], True) + a01 * i16(g[:, wa], False)
             + a10 * i16(g[:, wb], True) + a11 * i16(g[:, wb], False))
        out.append(r * scale[ch])
    for j, ch in enumerate((2, 3, 4)):
        word = g[:, 4 + j]
        r = (a00 * i8(word, 0) + a01 * i8(word, 1)
             + a10 * i8(word, 2) + a11 * i8(word, 3))
        out.append(r * scale[ch])
    return out


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor,
                    dy: torch.Tensor,
                    R1_packed: tuple[torch.Tensor, torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """Flow-compensated normal-equation planes M (5, H, W).

    The warp samples R1 at the absolute position (j + dx, i + dy): floor and
    fraction are taken of the position, not of the displacement.  With
    ``R1_packed`` (from :func:`pack_corner_pairs`) the corners come from the
    quantized int16/int8 table; without it the warp is exact.
    """
    _, h, w = R0.shape
    xs = torch.arange(w, dtype=dx.dtype, device=dx.device)[None, :]
    ys = torch.arange(h, dtype=dx.dtype, device=dx.device)[:, None]
    fx = xs + dx
    fy = ys + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    fx = fx - x1
    fy = fy - y1
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    # corners of pixels outside are never used: gather them from (0, 0)
    xi = torch.where(inside, x1, 0.0).to(torch.int64)
    yi = torch.where(inside, y1, 0.0).to(torch.int64)

    base = (yi * w + xi).reshape(-1)
    a00 = ((1 - fx) * (1 - fy))[None]
    a01 = (fx * (1 - fy))[None]
    a10 = ((1 - fx) * fy)[None]
    a11 = (fx * fy)[None]
    if R1_packed is not None:
        table, scale = R1_packed
        flat_w = (a00.reshape(-1), a01.reshape(-1), a10.reshape(-1), a11.reshape(-1))
        vals = _unpack_warp(table[base], scale, *flat_w)
        r = torch.stack([v.reshape(h, w) for v in vals])
    else:
        flat = R1.reshape(5, h * w)

        # an index past the end (a pixel outside, on a level of one row or
        # column) is clamped, as JAX's gather clamps it
        def take(offset):
            return flat[:, torch.clamp(base + offset, max=h * w - 1)].reshape(5, h, w)

        r = a00 * take(0) + a01 * take(1) + a10 * take(w) + a11 * take(w + 1)
    return matrices_from_samples(R0, r, inside, dx, dy, _border_scale(h, w, R0.device))


def matrices_from_samples(R0: torch.Tensor, r: torch.Tensor, inside: torch.Tensor,
                          dx: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    """M (5, H, W) from the source planes R0, the target's planes ``r``
    sampled at the flow (used where ``inside``), the flow and the certainty
    attenuation ``scale`` (H, W): the tail of :func:`update_matrices`, shared
    with the row-sharded warp."""
    r2 = torch.where(inside, r[0], 0.0)
    r3 = torch.where(inside, r[1], 0.0)
    r4 = torch.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = torch.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = torch.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ])


def box_blur5(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Normalized box filter (BORDER_REPLICATE) over (5, H, W), separable shift-add."""
    ones = np.ones(winsize, dtype=np.float32)
    out = _corr_axis(_corr_axis(M, ones, -2, "edge"), ones, -1, "edge")
    return out * float(np.float32(1.0 / (winsize * winsize)))


def gauss_window(winsize: int) -> np.ndarray:
    """OPTFLOW_FARNEBACK_GAUSSIAN window taps: sigma = (winsize//2)*0.3, normalized."""
    m = winsize // 2
    x = np.arange(-m, m + 1, dtype=np.float64)
    sigma = m * 0.3
    g = np.exp(-x * x / (2 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def gauss_blur5(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Gaussian window aggregation (cv2 flags=256), BORDER_REPLICATE."""
    g = gauss_window(winsize)
    return _corr_axis(_corr_axis(M, g, -2, "edge"), g, -1, "edge")


def solve_flow(Mb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel 2x2 solve with OpenCV's +1e-3 determinant regularizer."""
    g11, g12, g22, h1, h2 = Mb[0], Mb[1], Mb[2], Mb[3], Mb[4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


def farneback_level(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                    winsize: int, iterations: int, fast_warp: bool = True,
                    gaussian: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level: ``iterations`` x (matrices -> window -> solve).

    Levels of at least 128x256 run each iteration as one fused kernel (K3),
    with an exact warp of any displacement.  Smaller levels assemble M with
    :func:`update_matrices` and aggregate + solve with the K2 kernel; their warp
    is the packed int16/int8 one when ``fast_warp`` is set (as on the JAX
    package's kernel path, which packs there whatever its flag says), else
    exact.
    """
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels

    _, h, w = R0.shape
    if warp.eligible(h, w):
        for _ in range(iterations):
            dx, dy = flow_kernels.fused_iteration(R0, R1, dx, dy, winsize, gaussian)
        return dx, dy

    packed = pack_corner_pairs(R1) if fast_warp else None
    M = update_matrices(R0, R1, dx, dy, packed)
    for i in range(iterations):
        dx, dy = flow_kernels.blur_solve(M, winsize, gaussian)
        if i < iterations - 1:
            M = update_matrices(R0, R1, dx, dy, packed)
    return dx, dy


# ------------------------------------------------------------------ pyramid and refinement

def build_pyramid(im: torch.Tensor, pyr_scale: float, levels: int, poly_n: int,
                  poly_sigma: float) -> tuple[torch.Tensor, ...]:
    """Per-level (5, lh, lw) polynomial-expansion planes of one frame,
    coarsest first (the order :func:`flow_from_pyramids` consumes)."""
    h, w = im.shape
    return tuple(poly_exp(level_image(im, scale, lh, lw), poly_n, poly_sigma)
                 for _, scale, lh, lw in level_sizes(h, w, pyr_scale, levels))


def level_image(im: torch.Tensor, scale: float, lh: int, lw: int) -> torch.Tensor:
    """The (lh, lw) image of the pyramid level at ``scale``: cv2's pre-blur
    (sigma = (1/scale - 1) / 2) then the bilinear resize, rounded as the JAX
    package's jitted ``build_pyramid`` rounds them: the K8 kernel on the card
    (:mod:`.level_kernels`), :func:`level_image_reference` on the CPU."""
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels

    return level_kernels.level_image(im.to(torch.float32), scale, lh, lw)


def flow_from_pyramids(pyr1, pyr2, pyr_scale: float, winsize: int, iterations: int,
                       fast_warp: bool = True, gaussian: bool = False,
                       flow0: torch.Tensor | None = None) -> torch.Tensor:
    """Coarse-to-fine refinement over precomputed pyramids -> (H, W, 2) [dx, dy]."""
    dx = dy = None
    for R0, R1 in zip(pyr1, pyr2):
        _, lh, lw = R0.shape
        if dx is None:
            if flow0 is not None:  # OPTFLOW_USE_INITIAL_FLOW
                scale = float(np.float32(pyr_scale ** (len(pyr1) - 1)))
                f0 = torch.movedim(flow0.to(torch.float32), -1, 0).contiguous()  # (2, H, W)
                f0 = resize_bilinear(f0, lh, lw, scale)
                dx, dy = f0[0], f0[1]
            else:
                dx = torch.zeros((lh, lw), dtype=torch.float32, device=R0.device)
                dy = torch.zeros((lh, lw), dtype=torch.float32, device=R0.device)
        else:
            f = resize_bilinear(torch.stack([dx, dy]), lh, lw, 1.0 / pyr_scale)
            dx, dy = f[0], f[1]
        dx, dy = farneback_level(R0, R1, dx, dy, winsize, iterations, fast_warp, gaussian)
    return torch.stack([dx, dy], dim=-1)


def _farneback_impl(im1, im2, pyr_scale, levels, winsize, iterations, poly_n, poly_sigma,
                    fast_warp=True, gaussian=False, flow0=None):
    pyr1 = build_pyramid(im1, pyr_scale, levels, poly_n, poly_sigma)
    pyr2 = build_pyramid(im2, pyr_scale, levels, poly_n, poly_sigma)
    return flow_from_pyramids(pyr1, pyr2, pyr_scale, winsize, iterations, fast_warp,
                              gaussian, flow0)


def farneback_flow(im1: torch.Tensor, im2: torch.Tensor,
                   cfg: FarnebackConfig = FarnebackConfig(), fast_warp: bool = True,
                   flow0: torch.Tensor | None = None) -> torch.Tensor:
    """Dense flow im1 -> im2; returns (H, W, 2) [dx, dy] in pixels/frame, the
    counterpart of ``cv2.calcOpticalFlowFarneback(im1, im2, None, ...)``.
    ``cfg.flags`` honours OPTFLOW_FARNEBACK_GAUSSIAN and
    OPTFLOW_USE_INITIAL_FLOW (seed from ``flow0``)."""
    gaussian = bool(cfg.flags & OPTFLOW_FARNEBACK_GAUSSIAN)
    if (cfg.flags & OPTFLOW_USE_INITIAL_FLOW) and flow0 is None:
        raise ValueError("flags request OPTFLOW_USE_INITIAL_FLOW but flow0 is None")
    init = flow0 if (cfg.flags & OPTFLOW_USE_INITIAL_FLOW) else None
    return _farneback_impl(im1, im2, cfg.pyr_scale, cfg.levels, cfg.winsize,
                           cfg.iterations, cfg.poly_n, cfg.poly_sigma, fast_warp,
                           gaussian, init)


def farneback_flow_batched(im1: torch.Tensor, im2: torch.Tensor,
                           cfg: FarnebackConfig = FarnebackConfig(),
                           fast_warp: bool = True) -> torch.Tensor:
    """Flow over a leading batch of frame pairs: (B, H, W) -> (B, H, W, 2).

    The counterpart of the JAX package's ``farneback_flow_batched``, which
    runs the pairs one after another in one program rather than vmapped.
    Here each pair's flow is launched in turn on the pairs' device, its
    kernels queued behind the previous pair's with no synchronisation, and
    the flows are stacked.  As in the JAX package, ``cfg.flags`` is not
    read: box windows, no initial flow."""
    if im1.ndim != 3 or im1.shape != im2.shape:
        raise ValueError(f"expected two (B, H, W) batches, got {tuple(im1.shape)} "
                         f"and {tuple(im2.shape)}")
    return torch.stack([_farneback_impl(a, b, cfg.pyr_scale, cfg.levels, cfg.winsize,
                                        cfg.iterations, cfg.poly_n, cfg.poly_sigma, fast_warp)
                        for a, b in zip(im1, im2)])
