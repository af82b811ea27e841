"""Pipeline configurations.

A copy of the pipeline-A and GMFA (pipeline B) dataclasses of
``datmo_using_optical_flow_tpu.config`` (same field names, defaults,
``grid_shape`` and ``validate``) and of its YAML loading for both pipelines
(the reference's schema or the native one).  The port cannot import that
module: it imports yaml at import time, which the GPU deployment does not
carry; here only :func:`load_config` imports it.  ``tests/test_torch_boundary.py`` holds the
copy equal to the original.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"config validation failed: {msg}")


@dataclass(frozen=True)
class RansacConfig:
    """Ground-plane RANSAC (both pipelines run it in preprocess)."""

    distance_threshold: float = 0.5
    ransac_n: int = 5
    num_iterations: int = 5000

    def validate(self) -> None:
        _check(self.distance_threshold > 0, "ransac.distance_threshold must be > 0")
        _check(self.ransac_n >= 3, "ransac.ransac_n must be >= 3")
        _check(self.num_iterations >= 1, "ransac.num_iterations must be >= 1")


@dataclass(frozen=True)
class FarnebackConfig:
    """Dense-flow parameters (the reference's executed values)."""

    pyr_scale: float = 0.3
    levels: int = 5
    winsize: int = 15
    iterations: int = 5
    poly_n: int = 5
    poly_sigma: float = 5.0
    flags: int = 0  # 0 = box-blur aggregation; OPTFLOW_FARNEBACK_GAUSSIAN also supported

    def validate(self) -> None:
        _check(0 < self.pyr_scale < 1, "farneback.pyr_scale must be in (0, 1)")
        _check(self.levels >= 1, "farneback.levels must be >= 1")
        _check(self.winsize >= 3 and self.winsize % 2 == 1, "farneback.winsize must be odd >= 3")
        _check(self.iterations >= 1, "farneback.iterations must be >= 1")
        _check(self.poly_n in (5, 7), "farneback.poly_n must be 5 or 7 (OpenCV-compatible)")
        _check(self.poly_sigma > 0, "farneback.poly_sigma must be > 0")


@dataclass(frozen=True)
class MaskConfig:
    """Motion-mask thresholds."""

    alpha_p: float = 0.8
    alpha_cont: float = 0.2

    def validate(self) -> None:
        _check(self.alpha_p > 0, "masks.alpha_p must be > 0")
        _check(self.alpha_cont > 0, "masks.alpha_cont must be > 0")


@dataclass(frozen=True)
class DbscanConfig:
    """Pipeline-A clustering params."""

    eps: float = 5.0
    min_samples: int = 3

    def validate(self) -> None:
        _check(self.eps > 0, "dbscan.eps must be > 0")
        _check(self.min_samples >= 1, "dbscan.min_samples must be >= 1")


@dataclass(frozen=True)
class CapacityConfig:
    """Static buffer capacities: every device buffer has a fixed size and a mask."""

    max_raw_points: int = 65536      # decoded PCD points per frame
    max_roi_points: int = 8192       # after ground removal + ROI filter
    expansion_factor: int = 10       # densifier replication
    max_cells: int = 4096            # valid BEV cells fed to DBSCAN
    max_clusters: int = 32           # live clusters per frame
    max_tracks: int = 64             # track-table slots

    @property
    def max_expanded_points(self) -> int:
        return self.max_roi_points * self.expansion_factor

    def validate(self) -> None:
        for f in dataclasses.fields(self):
            _check(getattr(self, f.name) >= 1, f"capacities.{f.name} must be >= 1")


@dataclass(frozen=True)
class TrackerAConfig:
    """Pipeline-A tracking constants."""

    gamma: float = 0.5               # GNN gate
    process_noise: float = 0.1       # Q = process_noise * I4
    measurement_noise: float = 0.05  # R = measurement_noise * I4
    m1: int = 1
    n1: int = 4
    m2: int = 10
    n2: int = 15

    def validate(self) -> None:
        _check(self.gamma > 0, "tracker.gamma must be > 0")


@dataclass(frozen=True)
class PipelineAConfig:
    """Config for the optical-flow DATMO pipeline."""

    grid_resolution: tuple[float, float] = (0.2, 0.2)
    x_range: tuple[float, float] = (-20.0, 20.0)
    y_range: tuple[float, float] = (-20.0, 20.0)
    z_max: float = 2.0
    roi_bounds: tuple[float, float, float, float, float, float] = (-10.0, 10.0, -10.0, 10.0, -3.0, 1.0)
    dt: float = 1.0
    noise_std: float = 0.01          # densifier jitter
    bev_a: float = 0.5               # BEV cell value = (a*mean_z + b*std_z)/h_max
    bev_b: float = 0.5
    velocity_threshold: float = 0.1  # cells with |v| > 0.1 go to DBSCAN

    ransac: RansacConfig = field(default_factory=RansacConfig)
    farneback: FarnebackConfig = field(default_factory=FarnebackConfig)
    masks: MaskConfig = field(default_factory=MaskConfig)
    dbscan: DbscanConfig = field(default_factory=DbscanConfig)
    tracker: TrackerAConfig = field(default_factory=TrackerAConfig)
    capacities: CapacityConfig = field(default_factory=CapacityConfig)

    input_folder: str = ""
    output_folder: str = "datmo_output"
    pcd_files: tuple[str, ...] = ()

    @property
    def grid_shape(self) -> tuple[int, int]:
        """Number of BEV bins, matching ``np.arange(lo, hi, step)`` semantics."""
        nx = int(math.ceil((self.x_range[1] - self.x_range[0]) / self.grid_resolution[0] - 1e-9))
        ny = int(math.ceil((self.y_range[1] - self.y_range[0]) / self.grid_resolution[1] - 1e-9))
        return nx, ny

    def validate(self) -> "PipelineAConfig":
        _check(self.x_range[1] > self.x_range[0], "x_range must be increasing")
        _check(self.y_range[1] > self.y_range[0], "y_range must be increasing")
        _check(len(self.roi_bounds) == 6, "roi_bounds must have 6 entries")
        _check(self.grid_resolution[0] > 0 and self.grid_resolution[1] > 0, "grid_resolution > 0")
        _check(self.dt > 0, "dt must be > 0")
        _check(self.z_max > 0, "z_max must be > 0")
        self.ransac.validate()
        self.farneback.validate()
        self.masks.validate()
        self.dbscan.validate()
        self.tracker.validate()
        self.capacities.validate()
        return self


@dataclass(frozen=True)
class IcpConfig:
    """Point-to-point ICP (reference ``GMFA/GMFA.py:297-309``; Open3D defaults)."""

    threshold: float = 0.02
    max_iterations: int = 30
    relative_fitness: float = 1e-6
    relative_rmse: float = 1e-6

    def validate(self) -> None:
        _check(self.threshold > 0, "icp.threshold must be > 0")
        _check(self.max_iterations >= 1, "icp.max_iterations must be >= 1")


@dataclass(frozen=True)
class SomConfig:
    """Static-occupancy-map grid (``GMFA/GMFA.py:434-437``)."""

    grid_size: int = 200
    cell_resolution: tuple[float, float] = (0.2, 0.2)
    init_value: float = 0.05
    static_increment: float = 0.1
    moving_decrement: float = 0.1
    max_value: float = 0.95
    min_value: float = 0.05

    def validate(self) -> None:
        _check(self.grid_size >= 1, "som.grid_size must be >= 1")


@dataclass(frozen=True)
class GMFAConfig:
    """Config for the General Model-Free Approach pipeline (reference ``GMFA/``)."""

    roi_bounds: tuple[float, float, float, float, float, float] = (-20.0, 20.0, -20.0, 20.0, -3.0, 3.0)
    moving_roi_bounds: tuple[float, float, float, float] = (-20.0, 20.0, -20.0, 5.0)  # GMFA.py:472
    static_threshold: float = 0.2    # GMFA.py:431
    moving_threshold: float = 0.6    # GMFA.py:432
    dt: float = 0.1                  # GMFA.py:488,496
    noise_std: float = 0.01
    cost_threshold: float = 1.0      # GMFA.py:182
    # reference hard-codes min_samples=1000 at GMFA.py:480, ignoring its YAML (=3)
    dbscan: DbscanConfig = field(default_factory=lambda: DbscanConfig(eps=5.0, min_samples=1000))
    ransac: RansacConfig = field(default_factory=RansacConfig)
    icp: IcpConfig = field(default_factory=IcpConfig)
    som: SomConfig = field(default_factory=SomConfig)
    capacities: CapacityConfig = field(default_factory=CapacityConfig)
    kf_process_noise: tuple[float, float, float, float] = (0.1, 0.1, 0.01, 0.01)  # GMFA.py:152
    kf_measurement_noise: float = 0.05  # GMFA.py:497
    initial_covariance: float = 0.1     # GMFA.py:255

    input_folder: str = ""
    output_folder: str = "gmfa_output"
    pcd_files: tuple[str, ...] = ()

    def validate(self) -> "GMFAConfig":
        _check(len(self.roi_bounds) == 6, "roi_bounds must have 6 entries")
        _check(len(self.moving_roi_bounds) == 4, "moving_roi_bounds must have 4 entries")
        _check(self.moving_threshold > self.static_threshold, "moving_threshold must exceed static_threshold")
        _check(self.dt > 0, "dt must be > 0")
        self.dbscan.validate()
        self.ransac.validate()
        self.icp.validate()
        self.som.validate()
        self.capacities.validate()
        return self


# YAML loading: the reference's schemas (Optical_flow/config.yaml,
# GMFA/config.yaml) or the nested native one.

def _tup(x: Any) -> Any:
    return tuple(x) if isinstance(x, (list, tuple)) else x


def _subconfig(cls, raw: dict | None):
    raw = dict(raw or {})
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - fields
    _check(not unknown, f"unknown keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**{k: _tup(v) for k, v in raw.items()})


def pipeline_a_config_from_dict(raw: dict) -> PipelineAConfig:
    """Build a :class:`PipelineAConfig` from a reference-schema YAML dict.

    Reference keys consumed: grid_resolution, x_range, y_range, z_max, roi_bounds,
    ransac.*, farneback_params.*, masks.alpha_p/[0], masks.alpha_cont/[0], dt,
    dbscan_params.*, pcd_files, input_folder, output_folder.  Unlike the reference,
    the ransac/farneback blocks are honored.
    """
    raw = dict(raw)
    masks_raw = dict(raw.pop("masks", {}) or {})
    # reference stores thresholds as 1-element lists (Optical_flow/config.yaml:20-22)
    for k in ("alpha_p", "alpha_cont"):
        if k in masks_raw and isinstance(masks_raw[k], (list, tuple)):
            masks_raw[k] = masks_raw[k][0]
    fb_raw = dict(raw.pop("farneback_params", {}) or {})
    kw: dict[str, Any] = {}
    for key in ("grid_resolution", "x_range", "y_range", "z_max", "roi_bounds", "dt",
                "noise_std", "bev_a", "bev_b", "velocity_threshold",
                "input_folder", "output_folder", "pcd_files"):
        if raw.get(key) is not None:
            kw[key] = _tup(raw[key])
    cfg = PipelineAConfig(
        ransac=_subconfig(RansacConfig, raw.get("ransac")),
        farneback=_subconfig(FarnebackConfig, fb_raw),
        masks=_subconfig(MaskConfig, masks_raw),
        dbscan=_subconfig(DbscanConfig, raw.get("dbscan_params")),
        tracker=_subconfig(TrackerAConfig, raw.get("tracker")),
        capacities=_subconfig(CapacityConfig, raw.get("capacities")),
        **kw,
    )
    return cfg.validate()


def gmfa_config_from_dict(raw: dict) -> GMFAConfig:
    """Build a :class:`GMFAConfig` from a reference-schema YAML dict.

    DBSCAN's ``min_samples`` defaults to the 1000 the reference executes
    (GMFA.py:480 hard-codes it, ignoring its YAML's value) unless the dict
    sets it."""
    raw = dict(raw)
    kw: dict[str, Any] = {}
    for key in ("roi_bounds", "moving_roi_bounds", "static_threshold", "moving_threshold",
                "dt", "noise_std", "cost_threshold", "input_folder", "output_folder",
                "pcd_files"):
        if raw.get(key) is not None:
            kw[key] = _tup(raw[key])
    dbscan_raw = dict(raw.get("dbscan_params") or {})
    dbscan_raw.setdefault("min_samples", 1000)
    cfg = GMFAConfig(
        dbscan=_subconfig(DbscanConfig, dbscan_raw),
        ransac=_subconfig(RansacConfig, raw.get("ransac")),
        icp=_subconfig(IcpConfig, raw.get("icp")),
        som=_subconfig(SomConfig, raw.get("som")),
        capacities=_subconfig(CapacityConfig, raw.get("capacities")),
        **kw,
    )
    return cfg.validate()


def load_config(path: str, pipeline: str = "a") -> PipelineAConfig | GMFAConfig:
    """Load a YAML config file (reference schema or native schema) for
    pipeline ``"a"`` (``"optical_flow"``) or ``"b"`` (``"gmfa"``)."""
    import yaml  # only a YAML config needs pyyaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    if pipeline.lower() in ("a", "optical_flow"):
        return pipeline_a_config_from_dict(raw)
    if pipeline.lower() in ("b", "gmfa"):
        return gmfa_config_from_dict(raw)
    raise ValueError(f"unknown pipeline {pipeline!r}; expected 'a'/'optical_flow' or 'b'/'gmfa'")
