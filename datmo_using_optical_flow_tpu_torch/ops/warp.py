"""Warp-path predicates, the counterpart of the parts of
``datmo_using_optical_flow_tpu.ops.warp_pallas`` that the flow needs.

The JAX package guards its fused warp with :func:`flow_in_range` because its
TPU kernel can only reach a fixed window of displacements.  The port's CUDA
kernel gathers each pixel's corners directly and warps any displacement, so
the port never takes that guard; :func:`flow_in_range` is kept to tell when the
two packages' results may differ (out of range, JAX falls back to the packed
int16/int8 warp).
"""

from __future__ import annotations

import torch

# the JAX TPU kernel's window: floor(dy) in [AMIN, AMAX], floor(dx) in [BMIN, BMAX]
AMIN, AMAX = -16, 14
BMIN, BMAX = -64, 62


def eligible(h: int, w: int) -> bool:
    """Levels that run the fused iteration kernel (K3); smaller levels take
    update_matrices + the window/solve kernel (K2), as in the JAX package."""
    return h >= 128 and w >= 256


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
