"""Velocity grids and motion masks, the counterpart of
``datmo_using_optical_flow_tpu.ops.masks``.

* flow -> m/s and the curl angular velocity, and the continuity mask (the
  only mask pipeline A's step applies);
* the propagation masks (dead code in the reference's main loop, part of
  its API surface: ``compat``), as deterministic scatters;
* the crossing-number point-in-polygon test (the road filter of
  ``ops/clusters``).

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


def _scatter_last_writer(vx: torch.Tensor, vy: torch.Tensor, i2: torch.Tensor,
                         j2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-scatter each cell's velocity to cell (i2, j2) with numpy's
    last-writer-wins (row-major) order on collisions; cells no writer reaches
    get 0.

    A scatter with duplicate indices has no defined order on the card, so
    each writer's row-major rank is scattered with ``amax`` and the winner
    gathered, as the JAX package does."""
    h, w = vx.shape
    dev = vx.device
    ok = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
    target = torch.where(ok, i2.long() * w + j2.long(), h * w).reshape(-1)
    writer = torch.arange(h * w, dtype=torch.int64, device=dev)
    best = torch.full((h * w + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, target, writer, "amax")[:h * w]
    has = best >= 0
    src = torch.clamp(best, min=0)
    pvx = torch.where(has, vx.reshape(-1)[src], 0.0).reshape(h, w)
    pvy = torch.where(has, vy.reshape(-1)[src], 0.0).reshape(h, w)
    return pvx, pvy


def _propagation_gate(vx, vy, di, dj, alpha_p: float) -> torch.Tensor:
    """Cells whose forward-scattered velocity (each cell moved by ``(di,
    dj)`` cells, floored) equals their own within ``alpha_p``; int32."""
    h, w = vx.shape
    ii = torch.arange(h, device=vx.device)[:, None]
    jj = torch.arange(w, device=vx.device)[None, :]
    i2 = (ii + torch.floor(di)).to(torch.int32)
    j2 = (jj + torch.floor(dj)).to(torch.int32)
    pvx, pvy = _scatter_last_writer(vx, vy, i2, j2)
    return ((torch.abs(pvx - vx) <= alpha_p) & (torch.abs(pvy - vy) <= alpha_p)).to(torch.int32)


def propagation_mask(vx: torch.Tensor, vy: torch.Tensor, dt: float, grid_resolution,
                     alpha_p: float) -> torch.Tensor:
    """Propagation gate (``main.py:167-183``): scatter each cell's velocity to
    its predicted cell, keep cells where scattered ~= actual within alpha_p."""
    return _propagation_gate(vx, vy, vx * dt / grid_resolution[0],
                             vy * dt / grid_resolution[1], alpha_p)


def propagation_mask_with_acceleration(vx, vy, ax, ay, dt: float, grid_resolution,
                                       alpha_p: float) -> torch.Tensor:
    """Propagation gate with the 1/2 a t^2 term (``main.py:185-221``)."""
    dxr, dyr = grid_resolution
    return _propagation_gate(vx, vy, (vx * dt + 0.5 * ax * dt * dt) / dxr,
                             (vy * dt + 0.5 * ay * dt * dt) / dyr, alpha_p)


def points_in_polygon(points_xy: torch.Tensor, polygon_xy: torch.Tensor) -> torch.Tensor:
    """Crossing-number point-in-polygon test (the reference's shapely road
    filter, ``main.py:297-334``).

    ``points_xy``: (N, 2); ``polygon_xy``: (V, 2), an open or closed ring.
    Returns a bool mask; points exactly on an edge follow the half-open
    crossing convention (``shapely.contains`` for interior points)."""
    px = points_xy[:, 0][:, None]
    py = points_xy[:, 1][:, None]
    x1 = polygon_xy[:, 0][None, :]
    y1 = polygon_xy[:, 1][None, :]
    x2 = torch.roll(polygon_xy[:, 0], -1)[None, :]
    y2 = torch.roll(polygon_xy[:, 1], -1)[None, :]
    cond = (y1 > py) != (y2 > py)
    denom = torch.where(y2 - y1 == 0, 1.0, y2 - y1)
    xint = x1 + (py - y1) / denom * (x2 - x1)
    crossings = torch.sum(cond & (px < xint), dim=1)
    return (crossings % 2) == 1
