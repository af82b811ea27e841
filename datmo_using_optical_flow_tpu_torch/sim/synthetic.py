"""Deterministic synthetic LiDAR scenes (numpy only).

A copy of the scene generator of ``datmo_using_optical_flow_tpu.sim.synthetic``
(``BoxTarget``, ``SyntheticScene``, ``synthetic_frame`` and the helpers they
call), kept here so that the port and its smoke run need nothing of the JAX
package; ``tests/test_torch_sim.py`` holds the copy equal to the original, bit
for bit.  A frame is a ground plane at z = 0, static boxes and moving box
targets, with sensor noise, optional transient clutter and an optional LiDAR
shadow model; every frame is a function of (seed, frame index).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BoxTarget:
    """A box target: constant velocity, or constant acceleration (``accel``),
    or a constant-speed circle (``turn_rate``, rad/s, exclusive with
    ``accel``), present from ``spawn_frame`` up to ``despawn_frame``
    (exclusive; None = forever)."""

    center0: tuple[float, float, float] = (5.0, 0.0, 0.75)
    size: tuple[float, float, float] = (4.0, 2.0, 1.5)
    velocity: tuple[float, float] = (2.0, 0.5)  # m/s in x, y
    points_per_frame: int = 600
    accel: tuple[float, float] = (0.0, 0.0)     # m/s^2 in x, y
    turn_rate: float = 0.0
    spawn_frame: int = 0
    despawn_frame: int | None = None


@dataclass
class SyntheticScene:
    """Ground plane z = 0 plus targets and static boxes; ``clutter_blobs``
    transient point clusters per frame and ``occlusion`` (box shadows cast
    from a sensor at the origin) are off by default."""

    ground_points: int = 4000
    ground_extent: float = 20.0
    ground_noise: float = 0.02
    static_boxes: tuple[BoxTarget, ...] = field(default_factory=tuple)
    targets: tuple[BoxTarget, ...] = field(default_factory=lambda: (BoxTarget(),))
    sensor_noise: float = 0.01
    seed: int = 0
    clutter_blobs: int = 0
    clutter_points: int = 40
    clutter_extent: float = 15.0
    occlusion: bool = False


def _box_surface_points(rng: np.random.Generator, center: np.ndarray,
                        size: np.ndarray, n: int) -> np.ndarray:
    """``n`` points on the faces of an axis-aligned box (the four sides and
    the top), faces drawn in proportion to their area."""
    sx, sy, sz = size
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy])  # +-x, +-y, top
    faces = rng.choice(5, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, size=(n, 2))
    pts = np.zeros((n, 3))
    for f in range(5):
        m = faces == f
        k = int(m.sum())
        if k == 0:
            continue
        if f in (0, 1):
            pts[m, 0] = (0.5 if f == 0 else -0.5) * sx
            pts[m, 1] = u[m, 0] * sy
            pts[m, 2] = u[m, 1] * sz
        elif f in (2, 3):
            pts[m, 0] = u[m, 0] * sx
            pts[m, 1] = (0.5 if f == 2 else -0.5) * sy
            pts[m, 2] = u[m, 1] * sz
        else:  # top
            pts[m, 0] = u[m, 0] * sx
            pts[m, 1] = u[m, 1] * sy
            pts[m, 2] = 0.5 * sz
    return pts + center


def target_center(box: BoxTarget, frame_index: int, dt: float = 1.0) -> np.ndarray:
    """(3,) centre of a target at a frame: c0 + v t + a t^2 / 2, or the
    constant-speed circle when ``turn_rate`` is set."""
    t = dt * frame_index
    if box.turn_rate:
        s = float(np.hypot(*box.velocity))
        w = box.turn_rate
        th0 = float(np.arctan2(box.velocity[1], box.velocity[0]))
        th = th0 + w * t
        r = s / w
        return np.array(box.center0) + np.array(
            [r * (np.sin(th) - np.sin(th0)), r * (np.cos(th0) - np.cos(th)), 0.0])
    return (np.array(box.center0)
            + np.array([box.velocity[0], box.velocity[1], 0.0]) * t
            + 0.5 * np.array([box.accel[0], box.accel[1], 0.0]) * t * t)


def target_active(box: BoxTarget, frame_index: int) -> bool:
    """Whether a target exists at the frame (spawn inclusive, despawn exclusive)."""
    return frame_index >= box.spawn_frame and (
        box.despawn_frame is None or frame_index < box.despawn_frame)


def _occlude(pts: np.ndarray, occluders: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Drop points whose xy ray from the sensor at the origin passes within an
    occluder's footprint radius, where the occluder is nearer and tall enough
    to block the ray at that range."""
    keep = np.ones(len(pts), bool)
    pxy = pts[:, :2]
    pr = np.linalg.norm(pxy, axis=1)
    for center, size in occluders:
        cxy = center[:2]
        cr = np.linalg.norm(cxy)
        if cr < 1e-6:
            continue
        radius = 0.5 * float(np.hypot(size[0], size[1])) * 0.8  # footprint
        top = center[2] + 0.5 * size[2]
        along = pxy @ (cxy / cr)                    # range along the ray
        perp2 = np.maximum(pr ** 2 - along ** 2, 0.0)
        behind = (along > cr) & (perp2 < radius * radius)
        z_sensor = 2.0  # the ray's height where it passes the occluder
        with np.errstate(divide="ignore", invalid="ignore"):
            zray = z_sensor + (pts[:, 2] - z_sensor) * np.where(pr > 1e-6, cr / pr, 0.0)
        keep &= ~(behind & (zray < top))
    return pts[keep]


def synthetic_frame(scene: SyntheticScene, frame_index: int, dt: float = 1.0) -> np.ndarray:
    """The (N, 3) float64 point cloud of a frame; targets move by
    ``velocity * dt`` per frame (plus ``accel`` or ``turn_rate``)."""
    rng = np.random.default_rng(np.random.SeedSequence([scene.seed, frame_index]))
    parts = []
    g = rng.uniform(-scene.ground_extent, scene.ground_extent, size=(scene.ground_points, 2))
    gz = rng.normal(scale=scene.ground_noise, size=(scene.ground_points, 1))
    parts.append(np.concatenate([g, gz], axis=1))
    occluders: list[tuple[np.ndarray, np.ndarray]] = []
    for box in scene.static_boxes:
        c = np.array(box.center0)
        parts.append(_box_surface_points(rng, c, np.array(box.size), box.points_per_frame))
        occluders.append((c, np.array(box.size)))
    for box in scene.targets:
        c = target_center(box, frame_index, dt)
        # drawn even when inactive, so the rest of the frame does not depend
        # on spawn windows
        p = _box_surface_points(rng, c, np.array(box.size), box.points_per_frame)
        if target_active(box, frame_index):
            parts.append(p)
            occluders.append((c, np.array(box.size)))
    pts = np.concatenate(parts, axis=0)
    pts += rng.normal(scale=scene.sensor_noise, size=pts.shape)
    if scene.clutter_blobs:
        crng = np.random.default_rng(np.random.SeedSequence([scene.seed, frame_index, 9191]))
        blobs = []
        for _ in range(scene.clutter_blobs):
            c = crng.uniform([-scene.clutter_extent, -scene.clutter_extent, 0.3],
                             [scene.clutter_extent, scene.clutter_extent, 1.2])
            blobs.append(c + crng.normal(scale=0.25, size=(scene.clutter_points, 3)))
        pts = np.concatenate([pts] + blobs, axis=0)
    if scene.occlusion and occluders:
        pts = _occlude(pts, occluders)
    return pts
