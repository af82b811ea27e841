"""Halo exchange for row-sharded grids, the counterpart of
``datmo_using_optical_flow_tpu.parallel.halo``.

A grid sharded by rows over a :class:`~.mesh.RowGroup` needs, for a vertical
stencil of radius ``r``, ``r`` rows of each neighbour's block; the rows beyond
the image's top and bottom are made up as the unsharded stencil's padding
makes them.  Every function here runs on every rank of the group at once, on
that rank's block.
"""

from __future__ import annotations

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.ops.farneback import _corr_at, _corr_axis
from datmo_using_optical_flow_tpu_torch.parallel.mesh import RowGroup

EDGE_MODES = ("edge", "reflect101")


def halo_exchange_rows(x: torch.Tensor, radius: int, group: RowGroup,
                       edge_mode: str = "edge") -> torch.Tensor:
    """Pad a row-sharded block with ``radius`` rows of each neighbour's.

    ``x``: this rank's (..., H_local, W) block (leading axes, such as the five
    coefficient planes, travel together).  Returns (..., H_local + 2*radius,
    W).  At the global image edges the halo is made per ``edge_mode``:
    ``'edge'`` replication (the polynomial expansion's and the box filter's
    convention) or ``'reflect101'`` (cv2.GaussianBlur's
    BORDER_REFLECT_101), as JAX ``halo.py:37-46`` makes it.
    """
    if edge_mode not in EDGE_MODES:
        raise ValueError(f"edge_mode must be one of {EDGE_MODES}, got {edge_mode!r}")
    hl = x.shape[-2]
    if radius > hl or (edge_mode == "reflect101" and radius >= hl):
        raise ValueError(f"halo of {radius} rows from a block of {hl} rows "
                         f"({edge_mode}): the rows must come from the next rank alone")
    if radius == 0:
        return x
    top, bottom = x[..., :radius, :], x[..., hl - radius:, :]
    from_above, from_below = group.neighbour_rows(top, bottom)
    if from_above is None:
        from_above = (x[..., 1:radius + 1, :].flip(-2) if edge_mode == "reflect101"
                      else x[..., :1, :].expand(*x.shape[:-2], radius, x.shape[-1]))
    if from_below is None:
        from_below = (x[..., hl - radius - 1:hl - 1, :].flip(-2) if edge_mode == "reflect101"
                      else x[..., hl - 1:, :].expand(*x.shape[:-2], radius, x.shape[-1]))
    return torch.cat([from_above, x, from_below], dim=-2)


def sharded_sep_filter(x: torch.Tensor, ky: np.ndarray, kx: np.ndarray,
                       group: RowGroup) -> torch.Tensor:
    """Separable 2-D filter on a row-sharded block, edge-padded globally:
    ``ops.farneback.sep_filter(..., 'edge')`` of the whole image, this rank's
    rows, rounded as JAX's jitted one (each pass a chain of fmas).  The
    vertical pass reads its cross-shard rows from the halo; the horizontal
    pass is row-local."""
    ry = len(ky) // 2
    hl = x.shape[-2]
    padded = halo_exchange_rows(x, ry, group)
    # _corr_at edge-pads again; its rows [ry, ry + hl) read true halo rows only
    v = _corr_at(padded, ky, -2, pad_mode="edge")[..., ry:ry + hl, :]
    return _corr_at(v, kx, -1, pad_mode="edge")


def sharded_box_blur5(m: torch.Tensor, winsize: int, group: RowGroup) -> torch.Tensor:
    """Row-sharded ``ops.farneback.box_blur5`` of (5, H_local, W) planes."""
    r = winsize // 2
    hl = m.shape[-2]
    ones = np.ones(winsize, dtype=np.float32)
    v = _corr_axis(halo_exchange_rows(m, r, group), ones, -2, "edge")[..., r:r + hl, :]
    return _corr_axis(v, ones, -1, "edge") * float(np.float32(1.0 / (winsize * winsize)))
