"""The port's plots (``io/viz``) and GMFA's ``plot_dir`` against the JAX
package's.

Every plot function writes its file; the same packed frame observables
(the JAX package's layout with the moving cloud and the SOM, packed by both
packages to the same bytes) drawn by JAX's ``_save_frame_plots_host`` and by
the port's ``save_frame_plots`` give the same file names; a 3-frame
``process_files(plot_dir=)`` and ``run-b --plot-dir`` write the four plots of
every stepped frame under the JAX package's names; without matplotlib both
fail before the first frame.  (The JAX package's own ``plot_dir`` run takes
~70 s on a CPU and is not repeated here.)
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import GMFAConfig as JConfig
from datmo_using_optical_flow_tpu.models import gmfa as jgmfa
from datmo_using_optical_flow_tpu_torch.__main__ import main as cli
from datmo_using_optical_flow_tpu_torch.io import viz
from datmo_using_optical_flow_tpu_torch.models import gmfa
from test_torch_gmfa_process_files import _CAPS, _MOVING, _cfg, _reference_yaml
from test_torch_gmfa_process_files import seq  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_PLOTS = ("som_frame_{}.png", "moving_static_frame_{}.png", "positions_frame_{}.png",
          "final_positions_frame_{}.png")


def _names(frames) -> set:
    return {p.format(i) for i in frames for p in _PLOTS}


def test_every_plot_function_writes_its_file(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    cls = rng.choice([2, 3], 200)
    states = [rng.normal(size=4).astype(np.float32) for _ in range(3)]
    labels = rng.integers(-1, 3, 60)
    idx = rng.integers(0, 40, (60, 2))
    calls = {
        "tracks": lambda p: viz.visualize_tracks({1: states[0], 4: states[1]}, save_path=p),
        "clusters": lambda p: viz.visualize_filtered_clusters(
            labels, idx, rng.normal(size=60), rng.normal(size=60), (-20, 20), (-20, 20), 0.2,
            0.2, save_path=p),
        "moving_static": lambda p: viz.plot_moving_vs_static(pts, cls, states, save_path=p),
        "positions": lambda p: viz.visualize_positions_and_velocities(pts, cls, states,
                                                                      save_path=p),
        "final": lambda p: viz.visualize_final_positions_and_velocities(pts, states,
                                                                        save_path=p),
        "filtered": lambda p: viz.plot_filtered_cloud(pts, cls, save_path=p),
        "som": lambda p: viz.plot_som_heat_map(rng.random((50, 50)), save_path=p),
    }
    for name, draw in calls.items():
        path = str(tmp_path / f"{name}.png")
        draw(path)
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name
    viz.visualize_tracks({}, save_path=str(tmp_path / "empty.png"))  # no legend, no error
    assert os.path.getsize(tmp_path / "empty.png") > 0


def _frame_obs(n_moving: int, alive_slots) -> tuple:
    rng = np.random.default_rng(1)
    t = _CAPS["max_tracks"]
    alive = np.zeros(t, bool)
    alive[list(alive_slots)] = True
    table = {"state": rng.normal(size=(t, 4)).astype(np.float32),
             "cov": np.zeros((t, 4, 4), np.float32), "features": np.zeros((t, 4), np.float32),
             "tid": rng.integers(0, 100000, t).astype(np.int32),
             "age": np.ones(t, np.int32), "alive": alive}
    moving = np.zeros((_MOVING, 3), np.float32)
    moving[:n_moving] = rng.uniform(-10, 10, (n_moving, 3))
    out = {"skip": np.array(False), "classifications": np.zeros(1, np.int32),
           "residuals": np.zeros(1, np.float32), "moving_points": moving,
           "moving_count": np.array(n_moving, np.int32), "labels": np.zeros(_MOVING, np.int32),
           "n_clusters": np.array(2, np.int32), "transformation": np.eye(4, dtype=np.float32),
           "fitness": np.array(0.5, np.float32)}
    som = rng.random((200, 200)).astype(np.float32)
    return out, table, som


def test_frame_plots_from_packed_observables_match_jax(tmp_path):
    out, table, som = _frame_obs(300, (0, 3, 5))
    jpack, jpacker = jgmfa._cached_gmfa_obs_pack(JConfig(capacities=JCapacity(**_CAPS)),
                                                 _MOVING, True)
    pack, packer = gmfa.obs_packer(_cfg(), _MOVING)
    want = np.asarray(jpack(jgmfa.GmfaOutputs(**{n: jnp.asarray(v) for n, v in out.items()}),
                            jgmfa.TrackTableB(**{n: jnp.asarray(v) for n, v in table.items()}),
                            jnp.asarray(som)))
    got = pack(gmfa.GmfaOutputs(**{n: torch.as_tensor(v) for n, v in out.items()}),
               gmfa.TrackTableB(**{n: torch.as_tensor(v) for n, v in table.items()}),
               torch.as_tensor(som)).numpy()
    np.testing.assert_array_equal(got, want)
    jgmfa.GMFAPipeline._save_frame_plots_host(str(tmp_path / "jax"), 7, jpacker.unpack(want))
    gmfa.save_frame_plots(str(tmp_path / "port"), 7, packer.unpack(got))
    assert set(os.listdir(tmp_path / "port")) == set(os.listdir(tmp_path / "jax")) == _names([7])


def test_process_files_plot_dir(seq, tmp_path):
    _, paths = seq
    res = gmfa.GMFAPipeline(_cfg(), max_moving_points=_MOVING, device="cpu").process_files(
        paths[:3], plot_dir=str(tmp_path / "plots"))
    stepped = sorted({r["Frame"] + 1 for r in res["rows"]})
    assert stepped == [1, 2]  # neither step was skipped
    assert set(os.listdir(tmp_path / "plots")) == _names(stepped)


def test_cli_run_b_plot_dir(seq, tmp_path, capsys):
    _, paths = seq
    folder = os.path.dirname(paths[0])
    raw = _reference_yaml(folder)
    raw["pcd_files"] = list(paths[:3])
    with open(tmp_path / "gmfa.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    assert cli(["run-b", str(tmp_path / "gmfa.yaml"), "-o", str(tmp_path / "t.xlsx"),
                "--plot-dir", str(tmp_path / "plots"), "--device", "cpu"]) == 0
    assert "track-log rows" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "t.csv")
    assert set(os.listdir(tmp_path / "plots")) == _names([1, 2])


def test_plot_dir_without_matplotlib_fails_before_the_first_frame(seq, tmp_path,
                                                                  monkeypatch):
    _, paths = seq

    def no_frame(*args, **kwargs):
        raise AssertionError("a frame was preprocessed")

    monkeypatch.setattr(gmfa.GMFAPipeline, "preprocess", no_frame)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pipe = gmfa.GMFAPipeline(_cfg(), max_moving_points=_MOVING, device="cpu")
    with pytest.raises(ImportError):
        pipe.process_files(paths[:3], plot_dir=str(tmp_path / "plots"))
    with pytest.raises(ImportError):
        cli(["run-b", os.path.dirname(paths[0]), "-o", str(tmp_path / "t.xlsx"),
             "--plot-dir", str(tmp_path / "plots"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "plots")
