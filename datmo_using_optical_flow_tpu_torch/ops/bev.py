"""BEV rasterisation, the counterpart of ``datmo_using_optical_flow_tpu.ops.bev``.

Same semantics as the JAX package (and the reference's ``compute_bev_grid``,
``Optical_flow/main.py:98-126``): bins by truncation toward zero, so points in
``(x0 - w, x0)`` land in bin 0; cell value ``(a * mean(z) + b * std(z)) /
h_max`` with the two-pass population std; renormalised by the grid's max
(guarded for an empty grid); then ``trunc(v * 255)`` wrapped modulo 256 to
uint8, as numpy's ``astype(uint8)`` wraps a negative mean.

The JAX package sums each cell with ``segment_sum``, which on the CPU adds a
cell's values in point order.  ``index_add_`` on the card adds with atomics,
in an order that changes from run to run.  Here the points are sorted by cell
(a stable sort keeps point order inside a cell) and each cell is summed by
``torch.segment_reduce`` on a two-dimensional value tensor, which adds one
segment's values one after another, in point order, on both devices (no
atomics, and no host synchronisation with ``unsafe=True``).  So the card's
grid equals the CPU's, and both equal the JAX package's, bit for bit (the
std's square root is the correctly rounded one, :func:`utils.ordered.sqrt_rn`).
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.utils.ordered import sqrt_rn


def _cell_sums(values: torch.Tensor, order: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
    """Per-segment sums of the (N, C) ``values`` in point order: ``order``
    sorts the points by segment (stably), ``lengths`` counts each segment."""
    return torch.segment_reduce(values[order], "sum", lengths=lengths, unsafe=True)


def bev_cell_stats(points: torch.Tensor, mask: torch.Tensor, grid_shape: tuple[int, int],
                   x_range, y_range, grid_resolution
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell (count, mean_z, std_z), float32 arrays of ``grid_shape`` (=
    (nx, ny); row = x bin, as in the reference)."""
    nx, ny = grid_shape
    w, h = grid_resolution
    xi = torch.trunc((points[:, 0] - x_range[0]) / w).to(torch.int32)
    yi = torch.trunc((points[:, 1] - y_range[0]) / h).to(torch.int32)
    ok = mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    cell = torch.where(ok, xi * ny + yi, nx * ny).long()  # out of grid -> scratch segment
    num_segments = nx * ny + 1

    sorted_cell, order = torch.sort(cell, stable=True)
    # segment lengths from the sorted ids (bincount on the card reads the
    # largest id on the host to size its output)
    bounds = torch.searchsorted(sorted_cell, torch.arange(num_segments + 1, device=cell.device))
    lengths = bounds[1:] - bounds[:-1]
    z = points[:, 2]
    zm = torch.where(ok, z, 0.0)
    cnt = lengths.to(points.dtype)   # integer counts: exact in any order
    s1 = _cell_sums(zm[:, None], order, lengths)[:, 0]
    safe_cnt = torch.clamp(cnt, min=1.0)
    mean = s1 / safe_cnt
    dev = torch.where(ok, z - mean[cell], 0.0)
    s2 = _cell_sums((dev * dev)[:, None], order, lengths)[:, 0]
    std = sqrt_rn(s2 / safe_cnt)
    # the scratch segment's count is not a cell's: drop it
    return (cnt[:-1].reshape(nx, ny), mean[:-1].reshape(nx, ny), std[:-1].reshape(nx, ny))


def compute_bev_grid(points: torch.Tensor, mask: torch.Tensor, grid_shape: tuple[int, int],
                     x_range, y_range, grid_resolution, a: float = 0.5, b: float = 0.5,
                     h_max: float = 5.0) -> torch.Tensor:
    """uint8 BEV grid, bit-equal to the JAX package's ``compute_bev_grid``."""
    cnt, mean, std = bev_cell_stats(points, mask, grid_shape, x_range, y_range,
                                    grid_resolution)
    vals = torch.where(cnt > 0, (a * mean + b * std) / h_max, 0.0)
    vmax = torch.max(vals)
    vals = vals / torch.where(vmax > 0, vmax, 1.0)
    i32 = torch.trunc(vals * 255.0).to(torch.int32)
    return torch.remainder(i32, 256).to(torch.uint8)
