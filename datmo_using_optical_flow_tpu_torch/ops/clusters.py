"""Cluster post-processing, the counterpart of
``datmo_using_optical_flow_tpu.ops.clusters`` (dead code in the reference's
main loop, part of its API surface: ``compat``):

* each cluster's mean speed (``calculate_dbscan_cluster_velocities``,
  ``Optical_flow/main.py:261-294``);
* the road-polygon cluster filter (``filter_clusters_by_roi``,
  ``main.py:297-334``; shapely in the reference, a crossing-number test here).
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.ops.masks import points_in_polygon
from datmo_using_optical_flow_tpu_torch.utils.ordered import segment_sum, sqrt_rn


def _cell_velocities(rows: torch.Tensor, cols: torch.Tensor, vx: torch.Tensor,
                     vy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r, c = torch.clamp(rows, min=0).long(), torch.clamp(cols, min=0).long()
    return vx[r, c], vy[r, c]


def cluster_mean_speeds(labels: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                        vx: torch.Tensor, vy: torch.Tensor, max_clusters: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean velocity magnitude per cluster (``main.py:261-294``): ``(speeds
    (K,), exists (K,))``, the reference's ``{cluster_id: avg_velocity}``.

    The sums run in a fixed tree (``ordered.segment_sum``), so the card and
    the CPU agree bit for bit; XLA's ``segment_sum`` adds in another order."""
    k = max_clusters
    valid = labels >= 0
    lab = torch.where(valid, labels, k)
    w, u = _cell_velocities(rows, cols, vx, vy)
    mag = sqrt_rn(w * w + u * u)
    cnt = segment_sum(valid.to(torch.float32), lab, k)
    s = segment_sum(torch.where(valid, mag, 0.0), lab, k)
    return s / torch.clamp(cnt, min=1.0), cnt > 0


def filter_clusters_by_polygon(labels: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                               vx: torch.Tensor, vy: torch.Tensor, polygon_xy: torch.Tensor
                               ) -> tuple[torch.Tensor, ...]:
    """Keep cluster cells inside a road polygon (``main.py:297-334``).

    The reference tests ``Point(col, row)`` (:321): the polygon lives in
    (col, row) grid coordinates.  Returns ``(labels, rows, cols, vx_cells,
    vy_cells, keep)``, where cells not kept have label -1."""
    pts = torch.stack([cols.to(torch.float32), rows.to(torch.float32)], dim=1)
    inside = points_in_polygon(pts, polygon_xy) & (labels >= 0)
    w, u = _cell_velocities(rows, cols, vx, vy)
    return torch.where(inside, labels, -1), rows, cols, w, u, inside
