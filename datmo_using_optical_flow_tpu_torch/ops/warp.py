"""Warp-path predicates, the counterpart of the parts of
``datmo_using_optical_flow_tpu.ops.warp_pallas`` that the flow needs.

The JAX package guards its fused warp with :func:`flow_in_range` because its
TPU kernel can only reach a fixed window of displacements.  The port's CUDA
kernel gathers each pixel's corners directly and warps any displacement, so
the port never takes that guard; :func:`flow_in_range` is kept to tell when the
two packages' results may differ (out of range, JAX falls back to the packed
int16/int8 warp).  :func:`exact_fused` says which small levels of the exact
warp the port runs through K3 as well: the JAX package keeps every level
below 128x256 out of its fused kernel, whose strip grid needs such tiles.
"""

from __future__ import annotations

import functools

import torch

# the JAX TPU kernel's window: floor(dy) in [AMIN, AMAX], floor(dx) in [BMIN, BMAX]
AMIN, AMAX = -16, 14
BMIN, BMAX = -64, 62


# csrc/flow_kernels.cu's kUniformMax: a level of at most this many rows and
# columns has one attenuation value, which XLA folds to a scalar; K4 has an
# instance for it, K3 does not.
UNIFORM_MAX = 4


def eligible(h: int, w: int) -> bool:
    """Levels that run the fused iteration kernel (K3) whatever the warp;
    smaller levels take the warp then the window/solve kernel (K2), as in
    the JAX package, unless the warp is exact and :func:`exact_fused`."""
    return h >= 128 and w >= 256


def window_broadcasts(h: int, w: int, winsize: int, gaussian: bool) -> bool:
    """Whether K2 sums the window of an h x w level through its
    broadcast-tap stage (``csrc/flow_kernels.cu::window_broadcast`` sets a
    mask): a Gaussian window on a level of two or more rows and three or more
    columns with an axis within its reach, where some taps read only edge
    padding (``ops/farneback.broadcast_taps``)."""
    if not gaussian or h < 2 or w < 3:
        return False
    from datmo_using_optical_flow_tpu_torch.ops.farneback import broadcast_taps, gauss_window

    g = gauss_window(winsize)
    return bool(broadcast_taps(g, h, True) or broadcast_taps(g, w, True))


@functools.lru_cache(maxsize=256)
def exact_fused(h: int, w: int, winsize: int, gaussian: bool) -> bool:
    """Whether an exact-warp level (``fast_warp=False``) runs each iteration
    as K3, the fused iteration, rather than K4 then K2: every level on which
    the card's K3 rounds as K4 then K2 do, which ``datmo_fused_iteration``
    takes.  It refuses the others, by the rules of ``csrc/flow_kernels.cu``
    this mirrors: levels under 2 rows or columns (K4's and K2's forms for a
    line), levels of at most :data:`UNIFORM_MAX` rows and columns (K4's
    ``kUniform`` instance) and those with a Gaussian window that
    :func:`window_broadcasts` (K2's ``kBcast`` stage)."""
    if h < 2 or w < 2 or (h <= UNIFORM_MAX and w <= UNIFORM_MAX):
        return False
    return not window_broadcasts(h, w, winsize, gaussian)


def fused(h: int, w: int, winsize: int, gaussian: bool, fast_warp: bool) -> bool:
    """Whether ``ops/farneback.farneback_level`` runs each iteration of an
    h x w level as K3, the fused iteration: every level that is
    :func:`eligible`, and with the exact warp (``fast_warp`` unset) every
    smaller one that :func:`exact_fused` admits.  The others take the warp
    (K4, or K9 with ``fast_warp``) then K2."""
    return eligible(h, w) or (not fast_warp and exact_fused(h, w, winsize, gaussian))


def flow_in_range(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """0-d bool: every pixel's integer displacement fits the JAX kernel's window
    (absolute-position arithmetic: floor(j + dx) - j)."""
    h, w = dx.shape
    gj = torch.arange(w, dtype=torch.float32, device=dx.device)[None, :]
    gi = torch.arange(h, dtype=torch.float32, device=dx.device)[:, None]
    x1 = torch.floor(gj + dx) - gj
    y1 = torch.floor(gi + dy) - gi
    return ((torch.amin(y1) >= AMIN) & (torch.amax(y1) <= AMAX)
            & (torch.amin(x1) >= BMIN) & (torch.amax(x1) <= BMAX))
