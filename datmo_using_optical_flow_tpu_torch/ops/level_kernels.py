"""The pyramid's level images and the flow's bilinear upsample (K8): CUDA
kernels, their dispatch and their launch counter.

No Pallas kernel does this work.  On the TPU, XLA fuses the JAX package's
``gaussian_blur`` and ``resize_bilinear`` (``ops/farneback.py:68,76``) into
the jitted ``build_pyramid`` and flow step, and its compiled CPU code, which
the port is held to, contracts each product into the add that takes it.  The
plain versions (``ops/farneback.py``: :func:`~.farneback.gaussian_blur_reference`,
:func:`~.farneback.resize_bilinear_reference`,
:func:`~.farneback.level_image_reference`) round as that code does through
K7's float64 form of the fma, about a dozen elementwise ops per fma, which
would be many hundred launches per 1080p step on the card.  The kernels of
``csrc/level_kernels.cu`` round each fma once (``__fmaf_rn``), in two
launches per level image or blur and one per resize.

Each wrapper dispatches on its input's device alone: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel on the current stream (and
counts each launch), any other device raises.  There is no fallback: a
failed build or launch raises.  Both give the same float32 bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops.flow_kernels import _on_cuda

# K8's kernel launches: two per level image or blur (the vertical pass, then
# the horizontal one, fused with the resize's lerps for a level image), one
# per resize
LAUNCHES = {"level_image": 0}
_LEVEL_IMAGE = build.Entry("datmo_level_image", "level_image")
_BLUR = build.Entry("datmo_blur", "level_image (blur)")
_RESIZE = build.Entry("datmo_resize", "level_image (resize)")
MAX_TAPS = 127  # csrc/level_kernels.cu: kMaxTaps


def reset_launches() -> None:
    LAUNCHES["level_image"] = 0


@functools.lru_cache(maxsize=16)
def _taps(ksize: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero float32 taps in ascending order: (offsets from the centre
    (int32), weights), the kernel's host arrays."""
    taps = fb.blur_taps(ksize, sigma)
    if len(taps) > MAX_TAPS:
        raise ValueError(f"ksize {len(taps)} over the kernel's {MAX_TAPS} taps")
    keep = np.flatnonzero(taps != 0.0)
    return (keep - len(taps) // 2).astype(np.int32), np.ascontiguousarray(taps[keep])


def _image(img: torch.Tensor, what: str) -> torch.Tensor:
    if img.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {img.dtype}")
    if img.ndim != 2:
        raise ValueError(f"{what}: expected (H, W), got {tuple(img.shape)}")
    return img.contiguous()


def blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """K8's blur: cv2.GaussianBlur (BORDER_REFLECT_101) of a float32 (H, W)
    image (the level image at scale 1, pyramid level 0)."""
    if not _on_cuda(img):
        return fb.gaussian_blur_reference(img, ksize, sigma)
    img = _image(img, "img")
    off, ws = _taps(ksize, float(sigma))
    if ksize == 1 or img.numel() == 0:
        return img
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    scratch = torch.empty_like(out)
    _BLUR(img.device.index, out.data_ptr(), img.data_ptr(), scratch.data_ptr(), h, w,
          off.ctypes.data, ws.ctypes.data, len(ws))
    LAUNCHES["level_image"] += 2
    return out


def level_image(im: torch.Tensor, scale: float, lh: int, lw: int) -> torch.Tensor:
    """K8: the (lh, lw) image of the pyramid level at ``scale`` of a float32
    (H, W) image, cv2's pre-blur then the bilinear resize: the vertical pass
    at the rows the resize reads into a ``(2 * lh, W)`` buffer, then the
    horizontal pass at the columns it reads, fused with both lerps."""
    if not _on_cuda(im):
        return fb.level_image_reference(im, scale, lh, lw)
    im = _image(im, "im")
    ksize, sigma = fb.level_blur(scale)
    h, w = im.shape
    if (lh, lw) == (h, w):
        return blur(im, ksize, sigma)
    off, ws = _taps(ksize, sigma)
    dev = im.device
    y0, y1, wy, _ = fb.resize_table(h, lh, dev)
    x0, x1, wx, _ = fb.resize_table(w, lw, dev)
    out = torch.empty((lh, lw), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    scratch = torch.empty((2 * lh, w), dtype=torch.float32, device=dev)
    _LEVEL_IMAGE(dev.index, out.data_ptr(), im.data_ptr(), scratch.data_ptr(), h, w, lh, lw,
                 y0.data_ptr(), y1.data_ptr(), wy.data_ptr(), x0.data_ptr(), x1.data_ptr(),
                 wx.data_ptr(), off.ctypes.data, ws.ctypes.data, len(ws))
    LAUNCHES["level_image"] += 2
    return out


def resize(img: torch.Tensor, out_h: int, out_w: int, scale: float = 1.0) -> torch.Tensor:
    """K8's resize: cv2.resize INTER_LINEAR of a float32 (..., H, W) over its
    last two axes, times the float32 ``scale`` (1.0: no multiply).  At the
    input's own shape there is nothing to resize, and the result is the
    input times ``scale``, as in the JAX package."""
    if not _on_cuda(img):
        return fb.resize_bilinear_reference(img, out_h, out_w, scale)
    if img.dtype != torch.float32 or img.ndim < 2 or img.numel() == 0:
        raise TypeError(f"img: expected a non-empty float32 (..., H, W), got {img.dtype} "
                        f"{tuple(img.shape)}")
    h, w = img.shape[-2], img.shape[-1]
    scale = float(np.float32(scale))
    if (out_h, out_w) == (h, w):
        return img if scale == 1.0 else img * scale
    dev = img.device
    out = torch.empty((*img.shape[:-2], out_h, out_w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    src = img.contiguous()
    y0, y1, wy, _ = fb.resize_table(h, out_h, dev)
    x0, x1, wx, _ = fb.resize_table(w, out_w, dev)
    _RESIZE(dev.index, out.data_ptr(), src.data_ptr(), src.numel() // (h * w), h, w, out_h,
            out_w, y0.data_ptr(), y1.data_ptr(), wy.data_ptr(), x0.data_ptr(), x1.data_ptr(),
            wx.data_ptr(), scale)
    LAUNCHES["level_image"] += 1
    return out
