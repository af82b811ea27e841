"""Point-cloud geometry ops, the counterpart of
``datmo_using_optical_flow_tpu.ops.points`` (mask-based, statically shaped).

* X-flip          — ``Optical_flow/main.py:65`` / ``GMFA/GMFA.py:36``
* ROI box filter  — ``filter_points_in_roi`` (``Optical_flow/main.py:30-36``)
* densifier       — ``increase_point_density`` (``Optical_flow/main.py:38-57``);
  the jitter is drawn from a key with :func:`utils.prng.normal_fma` (the JAX
  package's compiled ``rep + jax.random.normal(key) * noise_std``, bit for
  bit)
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.utils import prng


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


def densify(points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
            expansion_factor: int = 10, noise_std: float = 0.01
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicate each point ``expansion_factor`` times and add the jitter
    ``normal(key, (N * k, 3)) * noise_std`` as the JAX package's compiled
    preprocessing adds it (one rounding, ``prng.normal_fma``).

    ``np.repeat`` ordering (point i's replicas occupy rows ``i*k .. i*k+k-1``);
    padding rows keep their sentinel coordinates.  Returns
    ``(expanded_points, expanded_mask)`` of static shape ``(N * k, 3)``.
    """
    k = expansion_factor
    rep = torch.repeat_interleave(points, k, dim=0)
    rep_mask = torch.repeat_interleave(mask, k, dim=0)
    out = prng.normal_fma(key, rep, noise_std)
    return torch.where(rep_mask[:, None], out, rep), rep_mask
