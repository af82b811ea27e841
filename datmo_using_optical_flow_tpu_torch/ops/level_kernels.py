"""The pyramid's level images and the flow's bilinear upsample (K8): CUDA
kernels, their plans, their dispatch and their launch counter.

No Pallas kernel does this work.  On the TPU, XLA fuses the JAX package's
``gaussian_blur`` and ``resize_bilinear`` (``ops/farneback.py:68,76``) into
the jitted ``build_pyramid`` and flow step, and its compiled CPU code, which
the port is held to, contracts each product into the add that takes it.  The
plain versions (``ops/farneback.py``: :func:`~.farneback.level_images_reference`,
:func:`~.farneback.level_image_reference`,
:func:`~.farneback.gaussian_blur_reference`,
:func:`~.farneback.resize_bilinear_reference`) round as that code does
through K7's float64 form of the fma, about a dozen elementwise ops per fma,
which would be many hundred launches per 1080p step on the card.  The
kernels of ``csrc/level_kernels.cu`` round each fma once (``__fmaf_rn``):
one launch for all of a frame's level images, one per resize.

The level images' tile plan, the int32 resize tables and the taps of every
level are computed here (:func:`level_plan`, :func:`resize_plan`), once per
shape, and uploaded once per device, so that a call passes a handful of
pointers and integers.

Each wrapper dispatches on its input's device alone: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel on the current stream (and
counts each launch), any other device raises.  There is no fallback: a
failed build or launch raises.  Both give the same float32 bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops.flow_kernels import _on_cuda

# K8's kernel launches: one per frame's level images (or per one-level call)
# and one per resize
LAUNCHES = {"level_image": 0}
_LEVEL_IMAGES = build.Entry("datmo_level_images", "level_image")
_RESIZE = build.Entry("datmo_resize", "level_image (resize)")
MAX_TAPS = 127  # csrc/level_kernels.cu: kMaxTaps
# The plan's layout (csrc/level_kernels.cu: kTileInts, kLevelInts, the flags)
TILE_INTS = 10   # level, r0, nr, q0, nq, pc0, npc, ps0, nps, 0
LEVEL_INTS = 10  # lh, lw, out, taps, count, rows, cols, wy, wx, flags
RESIZE, ONE_ROW, ONE_COL = 1, 2, 4
SMEM_BYTES = 232448   # shared memory a block may use on the H100
STATIC_SMEM = 640     # the kernel's own: the taps' weights and flags, rounded up
STAGE_BYTES = 48 * 1024  # a tile stages its source window when window and chains fit
FILL = 2 * 132        # tiles sought per level: two per SM of the H100
BLUR_COLS, RESIZE_COLS = 128, 32  # output columns a tile of a blur, of a resized level
ALIGN = 64            # each level's image starts on a 256-byte boundary of the output


def reset_launches() -> None:
    LAUNCHES["level_image"] = 0


@functools.lru_cache(maxsize=16)
def _taps(ksize: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero float32 taps in ascending order: (offsets from the centre
    (int32), weights), as the kernel reads them.  They are contiguous: a
    Gaussian's taps underflow to zero only at its tails, and the kernel
    reads a chain's values from its first offset on."""
    taps = fb.blur_taps(ksize, sigma)
    if len(taps) > MAX_TAPS:
        raise ValueError(f"ksize {len(taps)} over the kernel's {MAX_TAPS} taps")
    keep = np.flatnonzero(taps != 0.0)
    if len(keep) and keep[-1] - keep[0] + 1 != len(keep):
        raise ValueError(f"taps of ksize {ksize}, sigma {sigma}: a zero between nonzero taps")
    return (keep - len(taps) // 2).astype(np.int32), np.ascontiguousarray(taps[keep])


def _bits(a: np.ndarray) -> np.ndarray:
    """float32 values as the int32 words the kernels read back."""
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _table(size: int, out: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``fb.resize_table`` of one axis as int32 positions and float32 weights."""
    i0, i1, wgt, _ = fb.resize_table(size, out, torch.device("cpu"))
    return i0.numpy().astype(np.int32), i1.numpy().astype(np.int32), wgt.numpy()


class Plan(NamedTuple):
    """The level images of one (h, w) image at ``specs`` ((ksize, sigma, lh,
    lw) per level), as the kernel runs them."""
    words: np.ndarray      # int32: tiles, levels, then taps and tables
    ntiles: int
    smem: int              # dynamic shared memory bytes a block
    offsets: tuple         # each level's first value in the output
    size: int              # values of the output


def _tile_rows(lh: int, lw: int, tq: int, options: tuple) -> int:
    """The most rows a tile of ``tq`` columns may take (of ``options``) while
    the level still has :data:`FILL` tiles; the fewest when none does."""
    for tr in options:
        if -(-lh // tr) * -(-lw // tq) >= FILL:
            return tr
    return options[-1]


def _level_tiles(h: int, w: int, lh: int, lw: int, off: np.ndarray) -> list:
    """The tiles of one level (rows of :data:`TILE_INTS`, the level left 0)
    with each tile's shared-memory floats."""
    resize = (lh, lw) != (h, w)
    lo, hi = int(off[0]), int(off[-1])
    if resize:
        y0, y1, _ = _table(h, lh)
        x0, x1, _ = _table(w, lw)
    for tq in ((BLUR_COLS,) if not resize else (RESIZE_COLS, 16, 8, 4, 2, 1)):
        tq = min(tq, lw)
        tr = min(_tile_rows(lh, lw, tq, (32, 16, 8, 4, 2, 1) if not resize
                            else (16, 8, 4, 2, 1)), lh)
        tiles = []
        for r0 in range(0, lh, tr):
            nr = min(tr, lh - r0)
            vmin, vmax = (int(y0[r0]), int(y1[r0 + nr - 1])) if resize else (r0, r0 + nr - 1)
            nv = 2 * nr if resize else nr
            ps0, nps = vmin + lo, vmax - vmin + 1 + hi - lo
            for q0 in range(0, lw, tq):
                nq = min(tq, lw - q0)
                cmin, cmax = ((int(x0[q0]), int(x1[q0 + nq - 1])) if resize
                              else (q0, q0 + nq - 1))
                # aligned to 4 values: a window inside the image is staged
                # in 16-byte copies
                pc0 = (cmin + lo) // 4 * 4
                npc = -(-(cmax + hi + 1 - pc0) // 4) * 4
                floats = nv * npc
                staged = 4 * (floats + nps * npc) <= STAGE_BYTES
                if staged:
                    floats += nps * npc
                tiles.append(([0, r0, nr, q0, nq, pc0, npc, ps0 if staged else 0,
                               nps if staged else 0, 0], floats))
        if max(f for _, f in tiles) * 4 + STATIC_SMEM <= SMEM_BYTES:
            return tiles
    raise ValueError(f"no tile of the {lh}x{lw} level of {h}x{w} fits in shared memory")


@functools.lru_cache(maxsize=32)
def level_plan(h: int, w: int, specs: tuple) -> Plan:
    """The kernel's plan for the level images of an (h, w) image at
    ``specs``, a tuple of (ksize, sigma, lh, lw), one per level.

    Tiles of :data:`TILE_INTS` come first (the most work per tile first: the
    coarse levels' long chains start early and overlap the streaming
    levels), then one row of :data:`LEVEL_INTS` per level, then each
    level's taps (offsets, weight bits, whether another tap shares the
    weight) and, for a resized level, its tables (y0 then y1, x0 then x1,
    the weight bits of y1 and x1; ``fb.resize_table``'s)."""
    if h < 1 or w < 1:
        raise ValueError(f"no level images of an empty {h}x{w} image")
    tiles, levels, data, offsets = [], [], [], []
    size, at = 0, 0

    def put(a) -> int:
        nonlocal at
        data.append(np.asarray(a, dtype=np.int32))
        at += len(data[-1])
        return at - len(data[-1])

    for li, (ksize, sigma, lh, lw) in enumerate(specs):
        off, ws = _taps(ksize, sigma)
        shared = [int(np.count_nonzero(ws == x) > 1) for x in ws]
        flags = RESIZE * ((lh, lw) != (h, w)) | ONE_ROW * (h == 1) | ONE_COL * (w == 1)
        row = [lh, lw, size, put(np.concatenate([off, _bits(ws), shared])), len(ws), 0, 0,
               0, 0, flags]
        if flags & RESIZE:
            y0, y1, wy = _table(h, lh)
            x0, x1, wx = _table(w, lw)
            row[5:9] = [put(np.concatenate([y0, y1])), put(np.concatenate([x0, x1])),
                        put(_bits(wy)), put(_bits(wx))]
        levels.append(row)
        offsets.append(size)
        chains = 4 if flags & RESIZE else 1  # horizontal chains an output
        for tile, floats in (_level_tiles(h, w, lh, lw, off) if lh * lw else ()):
            tile[0] = li
            nv = tile[2] * (2 if flags & RESIZE else 1)
            tiles.append((tile, floats, (nv * tile[6] + chains * tile[2] * tile[4]) * len(ws)))
        size += -(-lh * lw // ALIGN) * ALIGN
    if size >= 2 ** 31:
        raise ValueError(f"{size} values of level images: over the kernel's int32 offsets")
    tiles.sort(key=lambda t: -t[2])  # stable: ties keep level and raster order
    head = len(tiles) * TILE_INTS + len(levels) * LEVEL_INTS
    for row in levels:  # table offsets from the start of the words
        row[3] += head
        if row[9] & RESIZE:
            row[5:9] = [x + head for x in row[5:9]]
    words = np.concatenate([np.asarray([t for t, _, _ in tiles], np.int32).reshape(-1),
                            np.asarray(levels, np.int32).reshape(-1), *data])
    smem = 4 * max((f for _, f, _ in tiles), default=0)
    return Plan(words, len(tiles), smem, tuple(offsets), size)


@functools.lru_cache(maxsize=32)
def _level_specs(levels: tuple) -> tuple:
    """``levels`` ((scale, lh, lw) per level) as :func:`level_plan`'s specs."""
    return tuple((*fb.level_blur(scale), lh, lw) for scale, lh, lw in levels)


@functools.lru_cache(maxsize=64)
def _device_words(kind: str, args: tuple, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A level plan's (``kind`` "levels") or a resize table's ("resize")
    words on ``device``, uploaded once with no host synchronisation: copied
    from pinned memory, the pinned copy kept beside the device copy."""
    words = level_plan(*args).words if kind == "levels" else resize_plan(*args)
    pinned = torch.from_numpy(words).pin_memory()
    return pinned.to(device, non_blocking=True), pinned


def _image(img: torch.Tensor, what: str) -> torch.Tensor:
    if img.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {img.dtype}")
    if img.ndim != 2:
        raise ValueError(f"{what}: expected (H, W), got {tuple(img.shape)}")
    return img.contiguous()


def _launch(img: torch.Tensor, specs: tuple) -> tuple[torch.Tensor, ...]:
    """One launch of the level images kernel: each spec's (lh, lw) image, as
    views of one output."""
    h, w = img.shape
    plan = level_plan(h, w, specs)
    dev = img.device
    out = torch.empty(plan.size, dtype=torch.float32, device=dev)
    if plan.ntiles:
        words = _device_words("levels", (h, w, specs), dev)[0]
        _LEVEL_IMAGES(dev.index, out.data_ptr(), img.data_ptr(), h, w, words.data_ptr(),
                      plan.ntiles, plan.smem)
        LAUNCHES["level_image"] += 1
    return tuple(out.as_strided((lh, lw), (lw, 1), o)
                 for o, (_, _, lh, lw) in zip(plan.offsets, specs))


def level_images(im: torch.Tensor, levels) -> tuple[torch.Tensor, ...]:
    """K8: every level image of a float32 (H, W) image in one launch, one
    (lh, lw) image per ``(scale, lh, lw)`` of ``levels``: cv2's pre-blur of
    the level at ``scale``, then the bilinear resize (at the image's own
    size, the blur alone).  The images are views of one output."""
    levels = tuple((float(s), int(lh), int(lw)) for s, lh, lw in levels)
    if not _on_cuda(im):
        return fb.level_images_reference(im, levels)
    im = _image(im, "im")
    return _launch(im, _level_specs(levels))


def level_image(im: torch.Tensor, scale: float, lh: int, lw: int) -> torch.Tensor:
    """K8: the (lh, lw) image of the pyramid level at ``scale`` of a float32
    (H, W) image: :func:`level_images` with one level."""
    if not _on_cuda(im):
        return fb.level_image_reference(im, scale, lh, lw)
    im = _image(im, "im")
    return _launch(im, _level_specs(((float(scale), lh, lw),)))[0]


def blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """K8's blur: cv2.GaussianBlur (BORDER_REFLECT_101) of a float32 (H, W)
    image, one level image at the image's own size."""
    if not _on_cuda(img):
        return fb.gaussian_blur_reference(img, ksize, sigma)
    img = _image(img, "img")
    if ksize == 1 or img.numel() == 0:
        return img
    h, w = img.shape
    return _launch(img, ((ksize, float(sigma), h, w),))[0]


@functools.lru_cache(maxsize=64)
def resize_plan(h: int, w: int, oh: int, ow: int) -> np.ndarray:
    """The resize kernel's int32 table of (h, w) -> (oh, ow): y0, y1 (oh
    each), x0, x1 (ow each), then the float32 bits of the weights of y1 (oh)
    and x1 (ow); ``fb.resize_table``'s values."""
    y0, y1, wy = _table(h, oh)
    x0, x1, wx = _table(w, ow)
    return np.concatenate([y0, y1, x0, x1, _bits(wy), _bits(wx)])


@functools.lru_cache(maxsize=64)
def _scale32(scale: float) -> float:
    return float(np.float32(scale))


def _resize_into(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor, pair_stride: int,
                 planes: int, h: int, w: int, scale: float) -> None:
    oh, ow = out.shape[-2:]
    dev = out.device
    table = _device_words("resize", (h, w, oh, ow), dev)[0]
    _RESIZE(dev.index, out.data_ptr(), a.data_ptr(), b.data_ptr(), pair_stride, planes, h, w,
            oh, ow, table.data_ptr(), scale)
    LAUNCHES["level_image"] += 1


def upsample(dx: torch.Tensor, dy: torch.Tensor, lh: int, lw: int, scale: float = 1.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's resize of the flow's two float32 (H, W) planes to (lh, lw), times
    the float32 ``scale`` (1.0: no multiply), in one launch with no stack:
    ``(dx, dy)``, views of one (2, lh, lw) output."""
    if not (dx.is_cuda and dy.is_cuda) and not _on_cuda(dx, dy):
        f = fb.resize_bilinear_reference(torch.stack([dx, dy]), lh, lw, scale)
        return f[0], f[1]
    if dx.device != dy.device or dx.dtype != torch.float32 or dy.dtype != torch.float32 \
            or dx.dim() != 2 or dx.shape != dy.shape or dx.numel() == 0:
        raise TypeError(f"dx, dy: expected two non-empty float32 (H, W) of one shape on one "
                        f"device, got {dx.dtype} {tuple(dx.shape)} on {dx.device} and "
                        f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    h, w = dx.shape
    scale = _scale32(scale)
    if (lh, lw) == (h, w):
        return (dx, dy) if scale == 1.0 else (dx * scale, dy * scale)
    out = torch.empty((2, lh, lw), dtype=torch.float32, device=dx.device)
    if out.numel():
        _resize_into(out, dx.contiguous(), dy.contiguous(), 0, 2, h, w, scale)
    return out.unbind(0)


def resize(img: torch.Tensor, out_h: int, out_w: int, scale: float = 1.0) -> torch.Tensor:
    """K8's resize: cv2.resize INTER_LINEAR of a float32 (..., H, W) over its
    last two axes, times the float32 ``scale`` (1.0: no multiply), the
    planes taken in pairs.  At the input's own shape there is nothing to
    resize, and the result is the input times ``scale``, as in the JAX
    package."""
    if not _on_cuda(img):
        return fb.resize_bilinear_reference(img, out_h, out_w, scale)
    if img.dtype != torch.float32 or img.ndim < 2 or img.numel() == 0:
        raise TypeError(f"img: expected a non-empty float32 (..., H, W), got {img.dtype} "
                        f"{tuple(img.shape)}")
    h, w = img.shape[-2], img.shape[-1]
    scale = _scale32(scale)
    if (out_h, out_w) == (h, w):
        return img if scale == 1.0 else img * scale
    out = torch.empty((*img.shape[:-2], out_h, out_w), dtype=torch.float32, device=img.device)
    if out.numel():
        src = img.contiguous()
        planes = src.numel() // (h * w)
        second = src.view(-1)[h * w:] if planes > 1 else src
        _resize_into(out, src, second, 2 * h * w, planes, h, w, scale)
    return out
