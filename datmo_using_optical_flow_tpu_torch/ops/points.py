"""Point-cloud geometry ops, the counterpart of
``datmo_using_optical_flow_tpu.ops.points`` (mask-based, statically shaped).

* X-flip          — ``Optical_flow/main.py:65`` / ``GMFA/GMFA.py:36``
* ROI box filter  — ``filter_points_in_roi`` (``Optical_flow/main.py:30-36``)
* densifier       — ``increase_point_density`` (``Optical_flow/main.py:38-57``);
  the jitter is passed in explicitly (``torch`` cannot draw ``jax.random``'s
  numbers, so callers make it with a seeded generator of their own)
"""

from __future__ import annotations

import torch


def flip_x(points: torch.Tensor) -> torch.Tensor:
    """Negate the X coordinate (``points[:, 0] = -points[:, 0]``, ``main.py:65``)."""
    return torch.cat([-points[:, :1], points[:, 1:]], dim=1)


def roi_mask(points: torch.Tensor, roi_bounds) -> torch.Tensor:
    """Inclusive axis-aligned box membership, ``roi_bounds = (x_min, x_max,
    y_min, y_max, z_min, z_max)``; the caller ANDs it with its validity mask."""
    x_min, x_max, y_min, y_max, z_min, z_max = roi_bounds
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return ((x >= x_min) & (x <= x_max) & (y >= y_min) & (y <= y_max)
            & (z >= z_min) & (z <= z_max))


def roi_mask_2d(points: torch.Tensor, roi_bounds_xy) -> torch.Tensor:
    """2-D (x, y) box membership (``GMFA/GMFA.py:371-381``)."""
    x_min, x_max, y_min, y_max = roi_bounds_xy
    x, y = points[:, 0], points[:, 1]
    return (x >= x_min) & (x <= x_max) & (y >= y_min) & (y <= y_max)


def densify(points: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor,
            expansion_factor: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicate each point ``expansion_factor`` times and add ``noise``
    (``(N * k, 3)``, already scaled by the noise std).

    ``np.repeat`` ordering (point i's replicas occupy rows ``i*k .. i*k+k-1``);
    padding rows keep their sentinel coordinates.  Returns
    ``(expanded_points, expanded_mask)`` of static shape ``(N * k, 3)``.
    """
    k = expansion_factor
    rep = torch.repeat_interleave(points, k, dim=0)
    rep_mask = torch.repeat_interleave(mask, k, dim=0)
    if tuple(noise.shape) != tuple(rep.shape):
        raise ValueError(f"noise: expected shape {tuple(rep.shape)}, got {tuple(noise.shape)}")
    out = rep + noise.to(points.dtype)
    return torch.where(rep_mask[:, None], out, rep), rep_mask
