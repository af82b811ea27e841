"""The port's CARLA capture harness (``sim/carla_harness.py``) and its
``simulate`` command, driven by the fake ``carla`` module of
``tests/test_carla_harness.py``: the JAX harness's assertions, the capture's
files byte-equal to the JAX harness's on the same fake, the CLI, a missing
``carla``, and the egg bootstrap."""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest

from datmo_using_optical_flow_tpu.sim import carla_harness as jharness
from datmo_using_optical_flow_tpu_torch.__main__ import main as cli
from datmo_using_optical_flow_tpu_torch.io.pcd import read_pcd
from datmo_using_optical_flow_tpu_torch.sim import carla_harness as tharness
from test_carla_harness import FakeClient, _make_fake_carla
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture()
def fake_carla(monkeypatch):
    monkeypatch.setitem(sys.modules, "carla", _make_fake_carla())


def test_run_simulation_capture_loop(fake_carla, tmp_path):
    out = tmp_path / "capture"
    tharness.run_simulation(host="fakehost", port=2099, town="Town02", output_dir=str(out),
                            num_ticks=100, save_every=30)
    client = FakeClient.last_instance
    assert (client.host, client.port, client.town) == ("fakehost", 2099, "Town02")
    world = client.world
    assert world.tick_count == 100
    setup, restored = world.applied_settings
    assert setup.synchronous_mode is True and restored.synchronous_mode is False
    assert setup.fixed_delta_seconds == pytest.approx(0.033)
    assert client.tm.synchronous is True and client.tm_port == 8000
    ids = [a.blueprint.id for a in world.actors]
    assert ids == ["model3", "sensor.lidar.ray_cast", "sensor.camera.rgb",
                   "sensor.other.collision", "vehicle.bh.crossbike"]
    assert all(a.destroyed for a in world.actors)
    ego, lidar, camera, collision, target = world.actors
    assert ego.autopilot and target.autopilot
    assert lidar.parent is ego and camera.parent is ego and collision.parent is ego
    assert lidar.blueprint.attributes["channels"] == "32"
    assert lidar.blueprint.attributes["points_per_second"] == "1000000"
    yaw = math.radians(30.0)
    assert target.transform.location.x == pytest.approx(10.0 + 10 * math.cos(yaw))
    assert target.transform.location.y == pytest.approx(20.0 + 10 * math.sin(yaw))
    save_frames = (0, 30, 60, 90)
    assert {p.name for p in out.glob("lidar_frame_*.pcd")} == \
        {f"lidar_frame_{i}.pcd" for i in save_frames}
    assert {p.name for p in out.glob("camera_frame_*.jpeg")} == \
        {f"camera_frame_{i}.jpeg" for i in save_frames}
    for i in save_frames:  # frame i saves the cloud of tick i + 1
        np.testing.assert_allclose(read_pcd(str(out / f"lidar_frame_{i}.pcd")),
                                   lidar.history[i], rtol=0, atol=1e-6)
    for name, seed in (("ego", 1.0), ("target", 2.0)):
        rows = (out / f"{name}_velocity.txt").read_text().strip().splitlines()
        assert len(rows) == 4
        frame, vx, vy, _ = rows[-1].split()
        assert frame == "90" and float(vx) == pytest.approx(seed * 1.5)
        assert float(vy) == pytest.approx(seed * -0.5)
    assert len(ego.applied_controls) == 100
    c = ego.applied_controls[-1]
    assert 0.0 <= c.throttle <= 0.8 and -1.0 <= c.steer <= 1.0
    assert len(world.spectator.transforms) == 10
    assert world.spectator.transforms[0].rotation.pitch == -90.0


def _capture(module, out, monkeypatch):
    monkeypatch.setitem(sys.modules, "carla", _make_fake_carla())  # a fresh fake world
    module.run_simulation(output_dir=str(out), num_ticks=65, save_every=30)
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


def test_files_byte_equal_to_jax_harness(tmp_path, monkeypatch):
    ours = _capture(tharness, tmp_path / "port", monkeypatch)
    theirs = _capture(jharness, tmp_path / "jax", monkeypatch)
    assert len(ours) == 3 + 3 + 2  # 3 PCDs, 3 JPEGs, 2 velocity logs
    assert ours == theirs


def test_simulate_cli(fake_carla, tmp_path):
    out = tmp_path / "cli"
    assert cli(["simulate", "--host", "fakehost", "-p", "2099", "--no-rendering",
                "--filter", "model3", "--output", str(out)]) == 0
    client = FakeClient.last_instance
    assert (client.host, client.port) == ("fakehost", 2099)
    assert client.world.tick_count == 5000
    assert client.world.applied_settings[0].no_rendering_mode is True
    assert client.world.actors[0].blueprint.id == "model3"
    assert len(list(out.glob("lidar_frame_*.pcd"))) == len(range(0, 5000, 30))


def test_missing_carla_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "carla", None)  # import fails
    with pytest.raises(ImportError, match="CARLA"):
        tharness.run_simulation(output_dir=str(tmp_path / "x"), num_ticks=1)


def test_bootstrap_carla_egg(tmp_path):
    assert tharness.bootstrap_carla_egg(str(tmp_path)) is None
    plat = "win-amd64" if os.name == "nt" else "linux-x86_64"
    egg = tmp_path / (f"carla-0.9.12-py{sys.version_info.major}."
                      f"{sys.version_info.minor}-{plat}.egg")
    egg.write_bytes(b"")
    (tmp_path / f"carla-0.9.12-py2.7-{plat}.egg").write_bytes(b"")
    try:
        assert tharness.bootstrap_carla_egg(str(tmp_path)) == str(egg)
        assert sys.path[0] == str(egg)
    finally:
        sys.path.remove(str(egg))
