"""Velocity grids and the continuity mask, the counterpart of the parts of
``datmo_using_optical_flow_tpu.ops.masks`` on pipeline A's step.

``np.gradient`` semantics (central differences, one-sided at the edges) are
replicated exactly by :func:`gradient`.
"""

from __future__ import annotations

import torch


def gradient(a: torch.Tensor, axis: int) -> torch.Tensor:
    """np.gradient along one axis: central differences, one-sided edges."""
    a = torch.movedim(a, axis, 0)
    interior = (a[2:] - a[:-2]) * 0.5
    first = (a[1] - a[0])[None]
    last = (a[-1] - a[-2])[None]
    return torch.movedim(torch.cat([first, interior, last], dim=0), 0, axis)


def velocity_from_flow(flow: torch.Tensor, x_range, y_range
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flow px/frame -> m/s + curl angular velocity.

    As the reference: the pixel size uses shape[1] for x and shape[0] for y,
    and dt is not applied.
    """
    vx_px, vy_px = flow[..., 0], flow[..., 1]
    pixel_size_x = (x_range[1] - x_range[0]) / flow.shape[1]
    pixel_size_y = (y_range[1] - y_range[0]) / flow.shape[0]
    velocity_x = vx_px * pixel_size_x
    velocity_y = vy_px * pixel_size_y
    angular_velocity = gradient(velocity_y, 1) - gradient(velocity_x, 0)
    return velocity_x, velocity_y, angular_velocity


def continuity_mask(vx: torch.Tensor, vy: torch.Tensor, alpha_cont: float) -> torch.Tensor:
    """|div v| and |curl v| gate; int32 mask like the reference."""
    div_v = gradient(vx, 1) + gradient(vy, 0)
    curl_v = gradient(vy, 1) - gradient(vx, 0)
    return ((torch.abs(div_v) <= alpha_cont) & (torch.abs(curl_v) <= alpha_cont)).to(torch.int32)
