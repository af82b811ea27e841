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
    """Separable 2-D filter over the last two axes, each pass a chain of
    once-rounded fmas (:func:`_corr_at`), as the JAX package's jitted
    ``sep_filter``."""
    return _corr_at(_corr_at(img, ky, -2, pad_mode=pad_mode), kx, -1, pad_mode=pad_mode)


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


def upsample(dx: torch.Tensor, dy: torch.Tensor, lh: int, lw: int,
             scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The flow's two planes resized to (lh, lw) as :func:`resize_bilinear`
    resizes their stack, in one K8 launch on the card and with no stack:
    ``(dx, dy)``."""
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels

    return level_kernels.upsample(dx, dy, lh, lw, scale)


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
             at: torch.Tensor | None = None, pad_mode: str = "reflect",
             shared: frozenset = frozenset()) -> torch.Tensor:
    """The 1-D correlation along ``axis`` (-2 or -1) with ``jnp.pad``'s
    ``pad_mode`` padding (reflect-101 or edge), at the positions ``at`` of
    that axis (every position when None): a chain of once-rounded fmas in
    ascending tap order, zero taps skipped
    (:func:`.round_kernels.fma_chain_reference`), as XLA's compiled
    ``_corr_axis`` rounds the level images' blur and the Gaussian window;
    the products of the taps in ``shared`` keep their own rounding.
    On an axis of length 1 every tap reads the one value, and XLA computes
    the product of taps of equal weight once: such products are rounded on
    their own and added."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    n, size = len(taps) // 2, img.shape[axis]
    pos = torch.arange(size, device=img.device) if at is None else at
    if pad_mode == "edge":
        def source(i):
            return torch.clamp(pos + (i - n), 0, size - 1)
    else:
        def source(i):
            return reflect101(pos + (i - n), size)
    if size == 1:
        ws = [float(w) for w in taps if w != 0.0]
        x = img.index_select(axis, torch.zeros_like(pos))
        return round_kernels.fma_chain_reference(
            [(i, w, x) for i, w in enumerate(ws)],
            frozenset(i for i, w in enumerate(ws) if ws.count(w) > 1))
    return round_kernels.fma_chain_reference(
        [(i, w, img.index_select(axis, source(i))) for i, w in enumerate(taps) if w != 0.0],
        shared)


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


def level_images_reference(im: torch.Tensor, levels) -> tuple[torch.Tensor, ...]:
    """Plain version of K8's level images: :func:`level_image_reference` at
    each ``(scale, lh, lw)`` of ``levels``."""
    return tuple(level_image_reference(im, scale, lh, lw) for scale, lh, lw in levels)


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


@functools.lru_cache(maxsize=64)
def uniform_attenuation(h: int, w: int) -> bool:
    """Whether every pixel of an h x w level has the same certainty
    attenuation (each axis of at most 4 positions, where BORDER_ATTEN's first
    two values are equal), which XLA then folds to one scalar constant."""
    def one_value(size):
        near = np.minimum(np.arange(size), size - 1 - np.arange(size))
        return len(set(np.where(near < BORDER, BORDER_ATTEN[np.minimum(near, BORDER - 1)],
                                1.0).tolist())) == 1
    return one_value(h) and one_value(w)


def _border_scale(h: int, w: int, device) -> torch.Tensor:
    """Certainty attenuation within BORDER=5 pixels of each edge, float32."""
    return (border_axis(torch.arange(h, device=device), h)[:, None]
            * border_axis(torch.arange(w, device=device), w)[None, :])


def corner_scale(R1: torch.Tensor) -> torch.Tensor:
    """The five planes' quantisation scales (5,) of :func:`pack_corner_pairs`:
    ``max(absmax, 1e-20) * fl(1 / qmax)``, qmax 32767 for planes 0-1 (int16)
    and 127 for planes 2-4 (int8).  XLA folds the division by the constant
    qmax into a multiply by its float32 reciprocal."""
    absmax = torch.amax(torch.abs(R1), dim=(1, 2))  # (5,)
    return torch.clamp(absmax, min=1e-20) * (1.0 / _qmax(R1.device))


def _qmax(device) -> torch.Tensor:
    return torch.where(torch.arange(5, device=device) < 2, 32767.0, 127.0)


def pack_corners(R1: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The packed table (H*W, 7) int32 of :func:`pack_corner_pairs` from R1
    and the planes' scales: each corner ``clip(round(v / scale), -qmax,
    qmax)`` (half to even, an IEEE division), passed through an integer."""
    _, h, w = R1.shape
    right = torch.cat([R1[:, :, 1:], R1[:, :, -1:]], dim=2)
    down = torch.cat([R1[:, 1:, :], R1[:, -1:, :]], dim=1)
    downright = torch.cat([right[:, 1:, :], right[:, -1:, :]], dim=1)
    corners = torch.stack([R1, right, down, downright])  # (4, 5, H, W)

    qb = _qmax(R1.device)[None, :, None, None]
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
    return table.reshape(h * w, 7)


def pack_corner_pairs(R1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize all four bilinear corners of all five planes into 7 int32 words
    per grid position (the JAX package's packed table, bit for bit):
    :func:`corner_scale` then :func:`pack_corners`.

    * words 0-1: channel 0 corners (A,B) / (C,D) as int16 pairs
    * words 2-3: channel 1 likewise
    * words 4-6: channels 2-4, all four corners as int8 bytes

    Corners: A = R1(y,x), B = (y,x+1), C = (y+1,x), D = (y+1,x+1),
    edge-replicated.  Returns ``(table (H*W, 7) int32, scale (5,))``, equal to
    the jitted ``pack_corner_pairs``; JAX keeps the same bits in a
    float32-typed table.  The card's K9 quantises the corners from R1
    where it reads them, and builds no table.
    """
    scale = corner_scale(R1)
    return pack_corners(R1, scale), scale


def _unpack_warp(g: torch.Tensor, a00, a01, a10, a11) -> list[torch.Tensor]:
    """Bilinear-combine the packed corners: (N, 7) rows -> list of 5 (N,)
    sums of the quantized corners, not yet times the planes' scales (XLA
    contracts that multiply into the add that takes it,
    :func:`matrices_from_samples`).  Each sum is :func:`_bilinear`'s chain."""
    def signed(v, bits):
        return (v - ((v >> (bits - 1)) << bits)).to(torch.float32)

    def i16(word, hi):
        return signed((word >> 16 if hi else word) & 0xFFFF, 16)

    def i8(word, byte):
        return signed((word >> (24 - 8 * byte)) & 0xFF, 8)

    out = []
    for wa, wb in ((0, 1), (2, 3)):
        # XLA's code takes the int16 planes' first two products the other
        # way round: fma(a01, c01, a00 * c00)
        out.append(_bilinear((a01, a00, a10, a11), (i16(g[:, wa], False), i16(g[:, wa], True),
                                                    i16(g[:, wb], True), i16(g[:, wb], False))))
    for j in range(3):
        word = g[:, 4 + j]
        out.append(_bilinear((a00, a01, a10, a11), [i8(word, byte) for byte in range(4)]))
    return out


def _bilinear(weights, corners) -> torch.Tensor:
    """``a00 * c00 + a01 * c01 + a10 * c10 + a11 * c11`` as XLA's compiled
    warp rounds it: ``fma(a11, c11, fma(a10, c10, fma(a00, c00, a01 *
    c01)))``."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    return round_kernels.fma_chain_reference(
        [(i, a, c) for i, (a, c) in enumerate(zip(weights, corners))])


def update_matrices(R0: torch.Tensor, R1: torch.Tensor | None, dx: torch.Tensor,
                    dy: torch.Tensor,
                    R1_packed: tuple[torch.Tensor, torch.Tensor] | None = None,
                    flow_scale: float | torch.Tensor | None = None) -> torch.Tensor:
    """Flow-compensated normal-equation planes M (5, H, W), rounded as the
    JAX package's jitted refinement: the plain version of K4 (exact warp)
    and of K9 (``R1_packed``, from :func:`pack_corner_pairs`: the corners
    come from the quantized int16/int8 table, and ``R1`` is not read).

    The warp samples R1 at the absolute position (j + dx, i + dy): floor and
    fraction are taken of the position, not of the displacement.  With
    ``flow_scale`` (a float32 number or an (H, W) tensor) the flow is
    ``(dx, dy) * flow_scale``, as where XLA recomputes it in the warp's
    fusion: the upsampled flow times 1 / pyr_scale, or the last solve's
    numerators times 1 / det.  Then the position is the once-rounded
    ``fma(dx, flow_scale, j)``, and M's flow terms take the rounded product.
    """
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    _, h, w = R0.shape
    xs = torch.arange(w, dtype=torch.float32, device=dx.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dx.device)[:, None]
    if flow_scale is None:
        fx, fy = xs + dx, ys + dy
    else:
        fx = round_kernels.fma32_reference(dx, flow_scale, xs)
        fy = round_kernels.fma32_reference(dy, flow_scale, ys)
        dx, dy = dx * flow_scale, dy * flow_scale
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    fx = fx - x1
    fy = fy - y1
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    # corners of pixels outside are never used: gather them from (0, 0)
    xi = torch.where(inside, x1, 0.0).to(torch.int64)
    yi = torch.where(inside, y1, 0.0).to(torch.int64)

    base = (yi * w + xi).reshape(-1)
    weights = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    scale = _border_scale(h, w, R0.device)
    if R1_packed is not None:
        table, r_scale = R1_packed
        vals = _unpack_warp(table[base], *(a.reshape(-1) for a in weights))
        r = torch.stack([v.reshape(h, w) for v in vals])
        return matrices_from_samples(R0, r, inside, dx, dy, scale, r_scale,
                                     flow_scale is not None)
    flat = R1.reshape(5, h * w)

    # an index past the end (a pixel outside, on a level of one row or
    # column) is clamped, as JAX's gather clamps it
    def take(offset):
        return flat[:, torch.clamp(base + offset, max=h * w - 1)].reshape(5, h, w)

    r = _bilinear([a[None] for a in weights], [take(o) for o in (0, 1, w, w + 1)])
    return matrices_from_samples(R0, r, inside, dx, dy, scale, None, flow_scale is not None)


def matrices_from_samples(R0: torch.Tensor, r: torch.Tensor, inside: torch.Tensor,
                          dx: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                          r_scale: torch.Tensor | None = None,
                          computed_flow: bool = False, folded: bool = True) -> torch.Tensor:
    """M (5, H, W) from the source planes R0, the target's planes ``r``
    sampled at the flow (used where ``inside``; times ``r_scale`` (5,), the
    packed table's scales, when given), the flow and the certainty
    attenuation ``scale`` (H, W): the tail of :func:`update_matrices`.

    Rounded as XLA compiles it for the CPU, where the attenuation is a
    constant: the packed scales and the flow terms are each contracted into
    the add that takes them, and ``(a * s) * (b * s)`` becomes
    ``(a * b) * s2`` with ``s2 = s * s`` folded, its first product of each
    sum contracted: ``M0 = fma(r4 r4, s2, (r6 r6) s2)``,
    ``M1 = fma(r4, s, r5 s) (r6 s)``, ``M3 = fma(r4 r2, s2, (r6 r3) s2)``,
    and so on.  Which product of ``h2 + r4 dy`` and ``h3 + r6 dy`` is
    contracted follows the operand order of each of XLA's loops, measured:
    ``r4 dy`` stays rounded on a level of one row or column, where no pixel
    is inside and LLVM folds the mask; in the packed warp it stays rounded
    in M4's, and in M3's on a level of one row, and of one column where the
    flow is ``computed_flow`` (a product XLA recomputes in the warp, see
    :func:`update_matrices`); ``r6 dy`` stays rounded in M3's in the packed
    warp with a ``computed_flow`` or on a level of one column, and in the
    exact warp with a ``computed_flow`` on a level of one row or column.
    Not ``folded`` (the row-sharded warp, whose
    attenuation depends on the rank): each value is scaled first,
    ``R = r * s``, ``M0 = fma(R4, R4, R6 R6)``, ``M3 = fma(R4, R2, R6 R3)``,
    and ``r4 dy`` stays rounded in M4.  On a level of more than one pixel
    whose attenuation is one value (:func:`uniform_attenuation`: at most 4
    rows and 4 columns) XLA folds it to a scalar and keeps the same unfolded
    form, M4's ``r4 dy`` contracted but on a level of one row or column,
    where ``M1 = (R4 + R5) R6``."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    fma = round_kernels.fma32_reference
    w = R0.shape[-1]
    if r_scale is None:
        d0, d1, s4, s5, s6 = (R0[c] - r[c] if c < 2 else R0[c] + r[c] for c in range(5))
    else:
        s4, s5, s6 = (fma(r[c], r_scale[c], R0[c]) for c in (2, 3, 4))
        # the difference takes the packed scale contracted in XLA's vector
        # loops (8 lanes), not in their scalar remainder: the last
        # (w - 1) % 8 + 1 columns of each row
        vec = torch.arange(w, device=R0.device) < (w - 1) // 8 * 8
        d0, d1 = (torch.where(vec, fma(r[c], -r_scale[c], R0[c]), R0[c] - r[c] * r_scale[c])
                  for c in (0, 1))
    r4 = torch.where(inside, s4 * 0.5, R0[2])
    r5 = torch.where(inside, s5 * 0.5, R0[3])
    r6 = torch.where(inside, s6 * 0.25, R0[4] * 0.5)
    h2 = torch.where(inside, d0, R0[0]) * 0.5
    h3 = torch.where(inside, d1, R0[1]) * 0.5
    terms: dict = {}

    def term(name: str, sep: bool) -> torch.Tensor:
        """``h2 + r4 dy + r6 dx`` ("r2") or ``h3 + r6 dy + r5 dx`` ("r3"),
        the last product contracted, the first one too unless ``sep``."""
        if (name, sep) not in terms:
            h, a, b = (h2, r4, r6) if name == "r2" else (h3, r6, r5)
            terms[name, sep] = fma(b, dx, h + a * dy if sep else fma(a, dy, h))
        return terms[name, sep]

    rows, one_line, packed = R0.shape[1], 1 in R0.shape[1:], r_scale is not None
    if packed:
        r2, r3 = term("r2", rows == 1 or (w == 1 and computed_flow)), \
            term("r3", computed_flow or w == 1)
    else:
        r2, r3 = term("r2", one_line), term("r3", computed_flow and one_line)
    r2_m4, r3_m4 = term("r2", packed or one_line or not folded), term("r3", False)
    m1 = fma(r4, scale, r5 * scale) * (r6 * scale)
    uniform = folded and not packed and rows * w > 1 and uniform_attenuation(rows, w)
    if not folded or uniform:
        R2, R3, R2_m4, R3_m4, R4, R5, R6 = (v * scale for v in (r2, r3, r2_m4, r3_m4, r4, r5, r6))
        if uniform and one_line:
            m1 = (R4 + R5) * R6
        return torch.stack([fma(R4, R4, R6 * R6), m1, fma(R5, R5, R6 * R6),
                            fma(R4, R2, R6 * R3), fma(R6, R2_m4, R5 * R3_m4)])
    s2 = scale * scale
    r66 = (r6 * r6) * s2
    return torch.stack([
        fma(r4 * r4, s2, r66),
        m1,
        fma(r5 * r5, s2, r66),
        fma(r4 * r2, s2, (r6 * r3) * s2),
        fma(r6 * r2_m4, s2, (r5 * r3_m4) * s2),
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


def broadcast_taps(taps: np.ndarray, size: int, trail: bool) -> frozenset:
    """The taps of a window pass over an axis of ``size`` values whose
    products keep their own rounding in XLA's compiled ``gauss_blur5``.
    A tap whose slice of the edge-padded axis is all padding reads one edge
    value, and XLA computes its product once, broadcast: the leading such
    taps (``k <= r - size``) form a chain of their own, onto which the rest
    is contracted, so a lead of one tap is a rounded product; the trailing
    ones (``k >= r + size``) are rounded and added where ``trail`` (where
    LLVM hoists their products out of the loop that adds them)."""
    r = len(taps) // 2
    lead = [k for k, t in enumerate(taps) if t != 0.0 and k <= r - size]
    out = set(lead) if len(lead) == 1 else set()
    if trail:
        out |= {k for k, t in enumerate(taps) if t != 0.0 and k >= r + size}
    return frozenset(out)


def gauss_blur5(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Gaussian window aggregation (cv2 flags=256), BORDER_REPLICATE: the
    vertical pass, then the horizontal one, each a chain of once-rounded
    fmas (:func:`_corr_at`), as XLA's compiled ``gauss_blur5`` rounds it.

    Where an axis is at most the window's radius some taps read only edge
    padding (:func:`broadcast_taps`).  At two or more rows and three or more
    columns: the vertical sums keep their trailing broadcast products
    contracted, but in the edge columns that pad them for the horizontal
    pass (computed in fusions of their own, where the products are hoisted
    and rounded); the horizontal pass rounds its trailing broadcast
    products."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    g = gauss_window(winsize)
    h, w = M.shape[-2:]
    if h < 2 or w < 3:
        return _corr_at(_corr_at(M, g, -2, pad_mode="edge"), g, -1, pad_mode="edge")
    vert = _corr_at(M, g, -2, pad_mode="edge", shared=broadcast_taps(g, h, False))
    edge = _corr_at(M, g, -2, pad_mode="edge", shared=broadcast_taps(g, h, True))
    r, pos = len(g) // 2, torch.arange(w, device=M.device)
    terms = []
    for k, t in enumerate(g):
        if t != 0.0:
            col = pos + (k - r)
            src = col.clamp(0, w - 1)
            terms.append((k, t, torch.where((col >= 0) & (col < w), vert.index_select(-1, src),
                                            edge.index_select(-1, src))))
    return round_kernels.fma_chain_reference(terms, broadcast_taps(g, w, True))


def solve_terms(Mb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-pixel 2x2 solve's numerators and 1 / det, with OpenCV's +1e-3
    determinant regularizer, rounded as XLA's compiled ``solve_flow``: each
    difference of products is ``fma(a, b, -(c * d))``.  The flow is
    ``(nx * idet, ny * idet)``."""
    from datmo_using_optical_flow_tpu_torch.ops import round_kernels

    fma = round_kernels.fma32_reference
    g11, g12, g22, h1, h2 = Mb[0], Mb[1], Mb[2], Mb[3], Mb[4]
    idet = 1.0 / (fma(g11, g22, -(g12 * g12)) + 1e-3)
    return fma(g11, h2, -(g12 * h1)), fma(g22, h1, -(g12 * h2)), idet


def solve_flow(Mb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel 2x2 solve -> (dx, dy), as XLA's compiled ``solve_flow``
    (:func:`solve_terms`)."""
    nx, ny, idet = solve_terms(Mb)
    return nx * idet, ny * idet


def farneback_level(R0: torch.Tensor, R1: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                    winsize: int, iterations: int, fast_warp: bool = True,
                    gaussian: bool = False,
                    flow_scale: float | torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level: ``iterations`` x (matrices -> window -> solve),
    from the flow ``(dx, dy)`` (times ``flow_scale``, see
    :func:`update_matrices`).

    Levels of at least 128x256 run each iteration as one fused kernel (K3),
    with an exact warp of any displacement, and so do the smaller levels of
    the exact warp (``fast_warp`` unset) that :func:`.warp.exact_fused`
    admits; M then never leaves the chip.  The other small levels assemble M
    with K4 (exact warp: a line, a level of at most 4x4, a Gaussian window
    with an axis within its reach) or, when ``fast_warp`` is set (as on the
    JAX package's kernel path, which packs there whatever its flag says),
    with K9, the packed warp: the planes' scales once per level
    (:func:`corner_scale`), then each iteration's corners quantised to
    int16/int8 from R1 with them (no table on the card), and aggregate +
    solve with K2.  Between iterations the flow is the solve's numerators
    times 1 / det, the form XLA's compiled refinement carries into the next
    warp.
    """
    from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk

    _, h, w = R0.shape
    if iterations < 1:
        return (dx, dy) if flow_scale is None else (dx * flow_scale, dy * flow_scale)
    fused = warp.fused(h, w, winsize, gaussian, fast_warp)
    scale = fk.corner_scale(R1) if fast_warp and not fused else None
    for i in range(iterations):
        terms = i < iterations - 1
        if fused:
            out = fk.fused_iteration(R0, R1, dx, dy, winsize, gaussian, flow_scale, terms)
        else:
            M = (fk.warp_matrices_packed(R0, R1, scale, dx, dy, flow_scale)
                 if scale is not None else fk.warp_matrices(R0, R1, dx, dy, flow_scale))
            out = fk.blur_solve(M, winsize, gaussian, terms)
        if terms:
            dx, dy, flow_scale = out
    return out


# ------------------------------------------------------------------ pyramid and refinement

def build_pyramid(im: torch.Tensor, pyr_scale: float, levels: int, poly_n: int,
                  poly_sigma: float) -> tuple[torch.Tensor, ...]:
    """Per-level (5, lh, lw) polynomial-expansion planes of one frame,
    coarsest first (the order :func:`flow_from_pyramids` consumes); the
    level images in one K8 launch on the card (:func:`level_images`)."""
    h, w = im.shape
    sizes = [(scale, lh, lw) for _, scale, lh, lw in level_sizes(h, w, pyr_scale, levels)]
    return tuple(poly_exp(img, poly_n, poly_sigma) for img in level_images(im, sizes))


def level_images(im: torch.Tensor, levels) -> tuple[torch.Tensor, ...]:
    """The (lh, lw) image of each ``(scale, lh, lw)`` pyramid level of
    ``levels``, as :func:`level_image` gives each: one K8 launch on the
    card (:mod:`.level_kernels`), :func:`level_images_reference` on the
    CPU."""
    from datmo_using_optical_flow_tpu_torch.ops import level_kernels

    return level_kernels.level_images(im.to(torch.float32), levels)


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
        # the level's flow is (dx, dy) times ``scale`` (None: 1), the
        # product XLA's compiled refinement recomputes in the warp
        if dx is None:
            scale = None
            if flow0 is not None:  # OPTFLOW_USE_INITIAL_FLOW
                f0 = torch.movedim(flow0.to(torch.float32), -1, 0).contiguous()  # (2, H, W)
                f0 = resize_bilinear(f0, lh, lw)
                dx, dy = f0[0], f0[1]
                scale = float(np.float32(pyr_scale ** (len(pyr1) - 1)))
                scale = None if scale == 1.0 else scale
            else:
                dx = torch.zeros((lh, lw), dtype=torch.float32, device=R0.device)
                dy = torch.zeros((lh, lw), dtype=torch.float32, device=R0.device)
        else:
            dx, dy = upsample(dx, dy, lh, lw)
            scale = float(np.float32(1.0 / pyr_scale))
        dx, dy = farneback_level(R0, R1, dx, dy, winsize, iterations, fast_warp, gaussian,
                                 scale)
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
