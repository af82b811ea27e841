"""The reference's API surface on the port, the counterpart of
``datmo_using_optical_flow_tpu.compat``.

Function-for-function equivalents of the reference's public surface
(``Optical_flow/main.py`` and ``GMFA/GMFA.py``), with the same names,
argument conventions and numpy-in/numpy-out behaviour. A user of the
reference can switch imports and keep the code that calls it:

    from datmo_using_optical_flow_tpu_torch.compat import (
        load_config, preprocess_pcd, compute_velocity_vectors,
        continuity_mask, dbscan_clustering, extract_cluster_data,
        track_clusters, manage_tracks, process_multiple_frames, EKF)

Every function that computes on a device takes ``device`` (default the
card, ``"cuda"``; it raises without one, see ``utils/device``); pass
``device="cpu"`` for the CPU.  As in the JAX package, randomness is seeded
(``seed=``), the first-frame acceleration crash is fixed, the config is
authoritative, and plots save to files instead of blocking.  Importing this
module needs neither pyyaml (imported by :func:`load_config`) nor
matplotlib (imported by the first plot).
"""

from __future__ import annotations

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.io.viz import visualize_tracks  # noqa: F401
from datmo_using_optical_flow_tpu_torch.oracle.reference_a import (  # noqa: F401
    RefEKF as EKF,
    extract_cluster_data,
    manage_tracks,
    track_clusters,
)
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def load_config(yaml_file: str) -> dict:
    """Raw-dict YAML load (``Optical_flow/main.py:25-28``)."""
    import yaml  # only a YAML config needs pyyaml

    with open(yaml_file, "r") as f:
        return yaml.safe_load(f)


def filter_points_in_roi(points: np.ndarray, roi_bounds, device: str = "cuda") -> np.ndarray:
    """Box filter (``main.py:30-36``), tested in float32 as the JAX package
    tests it."""
    from datmo_using_optical_flow_tpu_torch.ops.points import roi_mask

    keep = _np(roi_mask(_f32(points, resolve_device(device)), roi_bounds))
    return np.asarray(points)[keep]


def increase_point_density(points: np.ndarray, expansion_factor: int = 2,
                           noise_std: float = 0.01, seed: int = 0) -> np.ndarray:
    """Replication + jitter (``main.py:38-57``), seeded."""
    rng = np.random.default_rng(seed)
    rep = np.repeat(np.asarray(points), expansion_factor, axis=0)
    return rep + rng.normal(scale=noise_std, size=rep.shape)


def compute_bev_grid(points: np.ndarray, grid_resolution, x_range, y_range,
                     a: float = 0.5, b: float = 0.5, h_max: float = 5.0,
                     device: str = "cuda") -> np.ndarray:
    """uint8 BEV grid (``main.py:98-126``)."""
    from datmo_using_optical_flow_tpu_torch.io.frames import pad_points
    from datmo_using_optical_flow_tpu_torch.ops.bev import compute_bev_grid as dev_bev

    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    padded, mask = pad_points(pts, max(1, int(np.ceil(pts.shape[0] / 256)) * 256))
    nx = len(np.arange(x_range[0], x_range[1], grid_resolution[0]))
    ny = len(np.arange(y_range[0], y_range[1], grid_resolution[1]))
    return _np(dev_bev(torch.as_tensor(padded, device=dev), torch.as_tensor(mask, device=dev),
                       (nx, ny), tuple(x_range), tuple(y_range), tuple(grid_resolution),
                       a, b, h_max))


def preprocess_pcd(pcd_file: str, grid_resolution, x_range, y_range, z_max, roi_bounds,
                   seed: int = 0, device: str = "cuda") -> np.ndarray | None:
    """Read -> flip -> RANSAC ground removal -> ROI -> densify -> BEV
    (``main.py:59-95``) with the key ``PRNGKey(seed)``; None when the ROI is
    empty, like the reference."""
    from datmo_using_optical_flow_tpu_torch.config import PipelineAConfig
    from datmo_using_optical_flow_tpu_torch.io.frames import pad_points
    from datmo_using_optical_flow_tpu_torch.io.pcd import read_pcd
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.utils import prng

    dev = resolve_device(device)
    cfg = PipelineAConfig(grid_resolution=tuple(grid_resolution), x_range=tuple(x_range),
                          y_range=tuple(y_range), z_max=float(z_max),
                          roi_bounds=tuple(roi_bounds))
    padded, mask = pad_points(read_pcd(pcd_file, dtype=np.float32),
                              cfg.capacities.max_raw_points)
    bev = _np(PipelineA(cfg, dev).preprocess(torch.as_tensor(padded, device=dev),
                                             torch.as_tensor(mask, device=dev),
                                             prng.PRNGKey(seed).to(dev)))
    if not bev.any():
        print(f"No ROI points for {pcd_file}. Adjust ROI bounds.")
        return None
    return bev


def compute_velocity_vectors(bev1: np.ndarray, bev2: np.ndarray, x_range, y_range,
                             dt: float = 1.0, farneback_params: dict | None = None,
                             device: str = "cuda"):
    """Dense flow -> ``(velocity_x, velocity_y, angular_velocity)``
    (``main.py:131-164``; ``dt`` unused, as in the reference), the drop-in
    for ``cv2.calcOpticalFlowFarneback``.  The warp is exact on every level,
    as the JAX package's compat runs it."""
    from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
    from datmo_using_optical_flow_tpu_torch.ops.farneback import farneback_flow
    from datmo_using_optical_flow_tpu_torch.ops.masks import velocity_from_flow

    dev = resolve_device(device)
    flow = farneback_flow(_f32(bev1, dev), _f32(bev2, dev),
                          FarnebackConfig(**(farneback_params or {})), fast_warp=False)
    vx, vy, av = velocity_from_flow(flow, tuple(x_range), tuple(y_range))
    return _np(vx), _np(vy), _np(av)


def continuity_mask(vx: np.ndarray, vy: np.ndarray, alpha_cont: float,
                    device: str = "cuda") -> np.ndarray:
    """``main.py:224-228``."""
    from datmo_using_optical_flow_tpu_torch.ops import masks

    dev = resolve_device(device)
    return _np(masks.continuity_mask(_f32(vx, dev), _f32(vy, dev), alpha_cont))


def propagation_mask(vx, vy, dt, grid_resolution, alpha_p, device: str = "cuda") -> np.ndarray:
    """``main.py:167-183``."""
    from datmo_using_optical_flow_tpu_torch.ops import masks

    dev = resolve_device(device)
    return _np(masks.propagation_mask(_f32(vx, dev), _f32(vy, dev), dt,
                                      tuple(grid_resolution), alpha_p))


def propagation_mask_with_acceleration(vx, vy, ax, ay, dt, grid_resolution, alpha_p,
                                       device: str = "cuda") -> np.ndarray:
    """``main.py:185-221``."""
    from datmo_using_optical_flow_tpu_torch.ops import masks

    dev = resolve_device(device)
    return _np(masks.propagation_mask_with_acceleration(
        _f32(vx, dev), _f32(vy, dev), _f32(ax, dev), _f32(ay, dev), dt,
        tuple(grid_resolution), alpha_p))


def dbscan_clustering(vx_filtered: np.ndarray, vy_filtered: np.ndarray,
                      valid_mask: np.ndarray, eps: float = 1.0, min_samples: int = 5,
                      device: str = "cuda"):
    """``(labels, valid_indices)`` like ``main.py:231-259``: the valid cells'
    labels and (row, col) indices in row-major order."""
    from datmo_using_optical_flow_tpu_torch.ops.dbscan import dbscan_velocity_grid

    dev = resolve_device(device)
    valid = np.asarray(valid_mask, bool)
    h, w = valid.shape
    cap = max(256, int(np.ceil(int(valid.sum()) / 256)) * 256)
    labels, rows, cols, _, count = dbscan_velocity_grid(
        _f32(vx_filtered, dev), _f32(vy_filtered, dev), torch.as_tensor(valid, device=dev),
        eps, min_samples, (h, w), cap)
    n = int(count)
    return _np(labels)[:n], np.stack([_np(rows)[:n], _np(cols)[:n]], axis=1)


def calculate_dbscan_cluster_velocities(labels, valid_indices, vx_filtered,
                                        vy_filtered) -> dict:
    """``main.py:261-294``."""
    out = {}
    for cid in np.unique(labels):
        if cid == -1:
            continue
        pts = valid_indices[labels == cid]
        v = np.hypot(vx_filtered[pts[:, 0], pts[:, 1]], vy_filtered[pts[:, 0], pts[:, 1]])
        out[int(cid)] = float(v.mean())
    return out


def filter_clusters_by_roi(db_labels, valid_indices, velocity_grid, valid_mask,
                           road_polygon, device: str = "cuda"):
    """``main.py:297-334``; ``road_polygon`` is a (V, 2) array of (col, row)
    vertices (no shapely).  Returns the kept cells' labels, indices and
    velocities."""
    from datmo_using_optical_flow_tpu_torch.ops.clusters import filter_clusters_by_polygon

    dev = resolve_device(device)
    idx = torch.tensor(np.asarray(valid_indices), device=dev)
    _, _, _, w, u, keep = filter_clusters_by_polygon(
        torch.tensor(np.asarray(db_labels), device=dev), idx[:, 0], idx[:, 1],
        _f32(velocity_grid[0], dev), _f32(velocity_grid[1], dev), _f32(road_polygon, dev))
    keep = _np(keep)
    return (np.asarray(db_labels)[keep], np.asarray(valid_indices)[keep], _np(w)[keep],
            _np(u)[keep])


def process_multiple_frames(pcd_files, config, output_dir: str | None = None, seed: int = 0,
                            device: str = "cuda") -> dict:
    """The reference's main entry point (``main.py:541-641``): the port's
    pipeline A over the files, writing the artifacts; returns the final
    tracks.  ``config`` is the reference's raw YAML dict or a
    :class:`~datmo_using_optical_flow_tpu_torch.config.PipelineAConfig`."""
    from datmo_using_optical_flow_tpu_torch.config import (PipelineAConfig,
                                                           pipeline_a_config_from_dict)
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

    if isinstance(config, dict):
        cfg = pipeline_a_config_from_dict(config)
    else:
        cfg = config or PipelineAConfig()
    summary = PipelineA(cfg, device).process_files(list(pcd_files), output_dir=output_dir,
                                                   seed=seed)
    return summary["tracks"]
