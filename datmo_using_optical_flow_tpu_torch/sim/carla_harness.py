"""CARLA data-generation harness (port of ``single_target_simultion.py``).

A copy of ``datmo_using_optical_flow_tpu.sim.carla_harness`` whose PCD frames
go through the port's :mod:`datmo_using_optical_flow_tpu_torch.io.pcd`;
every other line is the original's (``tests/test_torch_boundary.py`` holds
the copy to it line for line).  LiDAR/camera rigs, spectator BEV, follow
controller, a synchronous 5000-tick loop writing PCD/JPEG frames and
ground-truth velocity logs every 30 ticks, with the reference's defects
fixed: ``attach_collision_sensor`` is defined (the reference calls an
undefined name at :235), one ``compute_control`` (the reference defines it
twice, :132/:159; the surviving second definition's behaviour is kept), and
``control`` is initialised before first use (:353).

``carla`` (and ``cv2``, for the camera frames) are imported only when the
capture runs; without ``carla`` every entry point raises a clear
ImportError.  Nothing here uses torch.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from dataclasses import dataclass

import numpy as np


def bootstrap_carla_egg(search_dir: str = ".") -> str | None:
    """S1 parity (``single_target_simultion.py:23-32``): locate a
    ``carla-<version>-py<major>.<minor>-<platform>.egg`` for the running
    interpreter and prepend it to ``sys.path``.  Returns the egg path (or
    None).  The reference hard-crashes on a missing egg glob; here it is an
    optional fallback tried before the clear ImportError."""
    import glob
    import sys

    pattern = os.path.join(
        search_dir,
        f"carla-*{sys.version_info.major}.{sys.version_info.minor}-"
        f"{'win-amd64' if os.name == 'nt' else 'linux-x86_64'}.egg")
    matches = sorted(glob.glob(pattern))
    if not matches:
        return None
    if matches[-1] not in sys.path:
        sys.path.insert(0, matches[-1])
    return matches[-1]


def _require_carla():
    try:
        import carla  # type: ignore

        return carla
    except ImportError:
        bootstrap_carla_egg()
    try:
        import carla  # type: ignore

        return carla
    except ImportError as e:  # pragma: no cover - no CARLA in CI
        raise ImportError(
            "The CARLA python package is required for the simulator harness "
            "(the reference used CARLA 9.12). Install the carla wheel or add the "
            "egg to sys.path; everything else in this framework runs without it "
            "(tests/benchmarks use sim.synthetic)."
        ) from e


@dataclass
class LidarSpec:
    """Reference LiDAR rig (``single_target_simultion.py:57-76``)."""

    range_m: float = 100.0
    channels: int = 32
    points_per_second: int = 1_000_000
    rotation_frequency: float = 30.0
    upper_fov: float = 15.0
    lower_fov: float = -30.0
    mount_z: float = 2.5


@dataclass
class CameraSpec:
    """Reference camera rig (``single_target_simultion.py:79-101``)."""

    width: int = 1920
    height: int = 1080
    fov: float = 110.0
    mount_x: float = 1.5
    mount_z: float = 2.4


def attach_lidar_to_vehicle(world, vehicle, spec: LidarSpec = LidarSpec()):
    carla = _require_carla()
    bp = world.get_blueprint_library().find("sensor.lidar.ray_cast")
    bp.set_attribute("range", str(spec.range_m))
    bp.set_attribute("channels", str(spec.channels))
    bp.set_attribute("points_per_second", str(spec.points_per_second))
    bp.set_attribute("rotation_frequency", str(spec.rotation_frequency))
    bp.set_attribute("upper_fov", str(spec.upper_fov))
    bp.set_attribute("lower_fov", str(spec.lower_fov))
    transform = carla.Transform(carla.Location(x=0.0, z=spec.mount_z))
    return world.spawn_actor(bp, transform, attach_to=vehicle)


def attach_camera_to_vehicle(world, vehicle, spec: CameraSpec = CameraSpec()):
    carla = _require_carla()
    bp = world.get_blueprint_library().find("sensor.camera.rgb")
    bp.set_attribute("image_size_x", str(spec.width))
    bp.set_attribute("image_size_y", str(spec.height))
    bp.set_attribute("fov", str(spec.fov))
    transform = carla.Transform(carla.Location(x=spec.mount_x, z=spec.mount_z))
    return world.spawn_actor(bp, transform, attach_to=vehicle)


def attach_collision_sensor(world, vehicle, callback=None):
    """Defined here (the reference calls this but never defines it, :235)."""
    carla = _require_carla()
    bp = world.get_blueprint_library().find("sensor.other.collision")
    sensor = world.spawn_actor(bp, carla.Transform(), attach_to=vehicle)
    if callback is not None:
        sensor.listen(callback)
    return sensor


def set_birds_eye_view(world, vehicle, height: float = 50.0) -> None:
    """Spectator 50 m above the ego, pitch -90 (``:103-129``)."""
    carla = _require_carla()
    spectator = world.get_spectator()
    loc = vehicle.get_transform().location
    spectator.set_transform(carla.Transform(
        carla.Location(x=loc.x, y=loc.y, z=loc.z + height),
        carla.Rotation(pitch=-90.0)))


def compute_control(ego_transform, target_transform):
    """P-controller following the target: throttle by distance band, steering by
    normalized yaw error (the reference's surviving definition, ``:159-192``).

    Returns (throttle, steer, brake) floats — framework-agnostic so it is
    testable without CARLA.
    """
    dx = target_transform["x"] - ego_transform["x"]
    dy = target_transform["y"] - ego_transform["y"]
    distance = math.hypot(dx, dy)

    if distance < 3.0:          # stop band
        throttle, brake = 0.0, 1.0
    elif distance < 7.0:        # safe-follow band
        throttle, brake = 0.3, 0.0
    else:
        throttle, brake = min(0.2 + 0.05 * distance, 0.8), 0.0

    desired_yaw = math.degrees(math.atan2(dy, dx))
    yaw_err = (desired_yaw - ego_transform["yaw"] + 180.0) % 360.0 - 180.0
    steer = max(-1.0, min(1.0, yaw_err / 90.0))
    return throttle, steer, brake


def lidar_to_xyz(raw_data) -> np.ndarray:
    """Decode a CARLA LiDAR measurement buffer to (N, 3) xyz (``:258-261``)."""
    pts = np.frombuffer(raw_data, dtype=np.float32).reshape(-1, 4)
    return pts[:, :3].copy()


def run_simulation(host: str = "127.0.0.1", port: int = 2000, town: str = "Town02",
                   output_dir: str = "carla_capture", num_ticks: int = 5000,
                   save_every: int = 30, fixed_delta: float = 0.033,
                   no_rendering: bool = False, vehicle_filter: str = "model3",
                   target_filter: str = "vehicle.bh.crossbike") -> None:
    """Synchronous capture loop (``single_target_simultion.py:197-374``):
    ego + target on autopilot, PCD + JPEG + velocity ground truth every
    ``save_every`` ticks, live FPS printout, clean teardown."""
    carla = _require_carla()
    import cv2

    from datmo_using_optical_flow_tpu_torch.io.pcd import write_pcd

    os.makedirs(output_dir, exist_ok=True)
    client = carla.Client(host, port)
    client.set_timeout(10.0)
    world = client.load_world(town)
    original_settings = world.get_settings()
    actors = []
    lidar_frames: list[np.ndarray] = []
    camera_frames: list[np.ndarray] = []
    try:
        settings = world.get_settings()
        settings.synchronous_mode = True
        settings.fixed_delta_seconds = fixed_delta
        settings.no_rendering_mode = no_rendering
        world.apply_settings(settings)
        tm = client.get_trafficmanager(8000)
        tm.set_synchronous_mode(True)

        blueprints = world.get_blueprint_library()
        ego_bp = blueprints.filter(vehicle_filter)[0]
        spawn = world.get_map().get_spawn_points()[0]
        ego = world.spawn_actor(ego_bp, spawn)
        actors.append(ego)

        lidar = attach_lidar_to_vehicle(world, ego)
        camera = attach_camera_to_vehicle(world, ego)
        collision = attach_collision_sensor(
            world, ego, lambda e: print(f"collision with {e.other_actor.type_id}"))
        actors += [lidar, camera, collision]
        lidar.listen(lambda data: lidar_frames.append(lidar_to_xyz(data.raw_data)))

        def camera_cb(image):
            arr = np.frombuffer(image.raw_data, dtype=np.uint8)
            camera_frames.append(arr.reshape(image.height, image.width, 4)[..., :3].copy())

        camera.listen(camera_cb)

        # target 10 m ahead (``:274-283``)
        target_bp = blueprints.filter(target_filter)[0]
        fwd = spawn.get_forward_vector()
        target_spawn = carla.Transform(
            carla.Location(spawn.location.x + 10 * fwd.x,
                           spawn.location.y + 10 * fwd.y, spawn.location.z),
            spawn.rotation)
        target = world.spawn_actor(target_bp, target_spawn)
        actors.append(target)
        ego.set_autopilot(True)
        target.set_autopilot(True)

        control = None  # defect #4 fix: defined before first use
        t_last, frames_done = time.time(), 0
        for frame in range(num_ticks):
            world.tick()
            if frame % 10 == 0:
                set_birds_eye_view(world, ego)
            if frame % save_every == 0:
                if lidar_frames:
                    write_pcd(os.path.join(output_dir, f"lidar_frame_{frame}.pcd"),
                              lidar_frames[-1])
                if camera_frames:
                    cv2.imwrite(os.path.join(output_dir, f"camera_frame_{frame}.jpeg"),
                                camera_frames[-1])
                for name, veh in (("ego", ego), ("target", target)):
                    v = veh.get_velocity()
                    with open(os.path.join(output_dir, f"{name}_velocity.txt"), "a") as f:
                        f.write(f"{frame} {v.x} {v.y} {v.z}\n")
                et, tt = ego.get_transform(), target.get_transform()
                throttle, steer, brake = compute_control(
                    {"x": et.location.x, "y": et.location.y, "yaw": et.rotation.yaw},
                    {"x": tt.location.x, "y": tt.location.y, "yaw": tt.rotation.yaw})
                control = carla.VehicleControl(throttle=throttle, steer=steer,
                                               brake=brake)
            if control is not None:  # applied every tick once computed (:352-353)
                ego.apply_control(control)
            frames_done += 1
            now = time.time()
            if now - t_last >= 1.0:
                print(f"FPS: {frames_done / (now - t_last):.1f}")
                t_last, frames_done = now, 0
    finally:
        world.apply_settings(original_settings)
        for a in actors:
            try:
                a.destroy()
            except Exception:
                pass


def main(argv=None) -> int:
    """CLI matching the reference's argparse surface (``:378-385``)."""
    p = argparse.ArgumentParser(description="CARLA DATMO capture harness")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=2000)
    p.add_argument("--no-rendering", action="store_true")
    p.add_argument("--filter", default="model3", help="ego vehicle blueprint filter")
    p.add_argument("--output", default="carla_capture")
    args = p.parse_args(argv)
    run_simulation(host=args.host, port=args.port, no_rendering=args.no_rendering,
                   vehicle_filter=args.filter, output_dir=args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
