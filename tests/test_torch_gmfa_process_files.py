"""GMFA (pipeline B) end to end: five synthetic PCD frames through the JAX
package's ``GMFAPipeline.process_files`` and the port's, at a small
configuration (8,192 raw points, 512 ROI points x10, ICP 0.2 m, DBSCAN
1.0 / 30, 2,048 moving points).  Also the track-log CSV, checkpoint and
resume in both directions, the runner's q16 path, ``run-b`` on a folder and
on a YAML config, and ``load_config(..., "b")``.

Both runners key frame i with ``split(fold_in(PRNGKey(0), i))``: the
expanded clouds come out bit-equal (``test_torch_gmfa_preprocess``) and the
new track ids are the same draws (``prng.randint``).  ICP's float32 rounds
part the two runs on frame pairs 1 -> 2 and 3 -> 4
(``test_torch_gmfa_icp_drift``: the two sides' Kabsch solves drift apart
until a correspondence near the gate falls on the other side of it; a
float64 ICP follows the port's transform until its own such parting).  So
rows are held as follows: ``Frame`` and ``Track ID`` exact and in the same
order; X, Y, VX, VY of the frames before the first parting within 1e-4
absolute plus 1e-5 relative (``test_torch_gmfa_pipeline``'s state
tolerance: centroid differences over dt = 0.1 s from float32 sums taken in
other orders); from
it on, positions within ``DRIFT_M`` and velocities within ``DRIFT_M / dt``:
the partings move the clusters' centroids by up to 1.0e-2 m (float32
points) and 1.8e-2 m (q16).  The SOM: every cell within 1e-6 but at most
``SOM_CELLS`` of its 40,000, the cells the parted classifications reach (52
float32, 100 q16).
"""

import csv
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import DbscanConfig as JDbscan
from datmo_using_optical_flow_tpu.config import GMFAConfig as JConfig
from datmo_using_optical_flow_tpu.config import IcpConfig as JIcp
from datmo_using_optical_flow_tpu.config import load_config as jload_config
from datmo_using_optical_flow_tpu.models import gmfa as jgmfa
from datmo_using_optical_flow_tpu.models.gmfa import GMFAPipeline as JPipeline
from datmo_using_optical_flow_tpu.models.gmfa import _cached_gmfa_obs_pack
from datmo_using_optical_flow_tpu_torch.__main__ import main as cli
from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig, GMFAConfig,
                                                       IcpConfig, load_config)
from datmo_using_optical_flow_tpu_torch.io.frames import DiskFrameSource
from datmo_using_optical_flow_tpu_torch.models.gmfa import (TRACK_LOG_COLUMNS, GMFAPipeline,
                                                             GmfaOutputs, TrackTableB, obs_packer)
from datmo_using_optical_flow_tpu_torch.sim.synthetic import (BoxTarget, SyntheticScene,
                                                              write_synthetic_sequence)
from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_CAPS = dict(max_raw_points=8192, max_roi_points=512, max_cells=1024, max_clusters=8,
             max_tracks=16)
_MOVING = 2048
N_FRAMES = 5
PARTINGS = (1, 3)  # the logged frames (``Frame`` = i - 1) whose steps' ICP parts the runs
DRIFT_M = 0.025  # metres, above the parting's 1.8e-2
SOM_CELLS = 200


def _cfg() -> GMFAConfig:
    return GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30), icp=IcpConfig(threshold=0.2),
                      capacities=CapacityConfig(**_CAPS))


def _port() -> GMFAPipeline:
    return GMFAPipeline(_cfg(), max_moving_points=_MOVING, device="cpu")


def _jax_pipe() -> JPipeline:
    cfg = JConfig(dbscan=JDbscan(eps=1.0, min_samples=30), icp=JIcp(threshold=0.2),
                  capacities=JCapacity(**_CAPS))
    return JPipeline(cfg, max_moving_points=_MOVING)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    scene = SyntheticScene(seed=33, targets=(
        BoxTarget(center0=(5.0, -4.0, 0.75), velocity=(1.5, 0.8), points_per_frame=300),
        BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
                  points_per_frame=250)))
    root = tmp_path_factory.mktemp("gmfa_pf")
    return root, write_synthetic_sequence(scene, str(root / "seq"), N_FRAMES)


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX package's run over all frames: the track log written and a
    checkpoint after frame 2."""
    root, paths = seq
    os.makedirs(root / "jax", exist_ok=True)
    return _jax_pipe().process_files(
        paths, output_xlsx=str(root / "jax" / "track_data.xlsx"), checkpoint_every=3,
        checkpoint_path=str(root / "jax_state.npz"))


@pytest.fixture(scope="module")
def port_run(seq):
    root, paths = seq
    os.makedirs(root / "port", exist_ok=True)
    return _port().process_files(paths, output_xlsx=str(root / "port" / "track_data.xlsx"),
                                 checkpoint_every=3, checkpoint_path=str(root / "port_state.npz"))


def _assert_rows_match(got: list[dict], want: list[dict]) -> None:
    """Rows of a run against JAX's: exact before the first parting among
    them, within the drift limits from it on (the module's docstring)."""
    assert len(got) == len(want) > 0
    assert [(r["Frame"], r["Track ID"]) for r in got] == \
        [(r["Frame"], r["Track ID"]) for r in want]
    parted = min(f for f in PARTINGS if f >= want[0]["Frame"])
    n = sum(r["Frame"] < parted for r in want)
    assert n > 0
    dt = _cfg().dt
    for col in ("X", "Y", "VX", "VY"):
        g, w = (np.array([r[col] for r in rows]) for rows in (got, want))
        np.testing.assert_allclose(g[:n], w[:n], atol=1e-4, rtol=1e-5, err_msg=col)
        limit = DRIFT_M / dt if col.startswith("V") else DRIFT_M
        np.testing.assert_allclose(g, w, atol=limit, rtol=0, err_msg=col)


def _assert_som_match(got: np.ndarray, want: np.ndarray) -> None:
    off = np.abs(got - want) > 1e-6
    print(f"SOM: {int(off.sum())} of {off.size} cells differ by more than 1e-6")
    assert int(off.sum()) <= SOM_CELLS


def test_process_files_matches_jax(jax_run, port_run):
    _assert_rows_match(port_run["rows"], jax_run["rows"])
    assert {r["Frame"] for r in jax_run["rows"]} == set(range(N_FRAMES - 1))  # none skipped
    _assert_som_match(port_run["som"], jax_run["som"])
    assert port_run["elapsed"] > 0
    assert set(port_run["timings"]) == {"preprocess", "step", "track_log", "track_log_transfer"}


def test_track_log_csv_matches_jax(seq, jax_run, port_run):
    """Both runners write ``track_data.csv`` for ``track_data.xlsx`` (no
    openpyxl): the same header and the same rows."""
    root, _ = seq
    tables = []
    for side in ("jax", "port"):
        assert not os.path.exists(root / side / "track_data.xlsx")
        with open(root / side / "track_data.csv", newline="") as f:
            tables.append(list(csv.reader(f)))
    want, got = tables
    assert got[0] == want[0] == list(TRACK_LOG_COLUMNS)
    rows = [[{k: float(v) for k, v in zip(t[0], r)} for r in t[1:]] for t in tables]
    _assert_rows_match(rows[1], rows[0])
    assert [r[:2] for r in got[1:]] == [r[:2] for r in want[1:]]  # frames and ids as written


def test_resume_equals_uninterrupted_run(seq, port_run):
    """The port's checkpoint after frame 2 (written during the whole run,
    after that frame's rows) resumes into the same rows and SOM."""
    root, paths = seq
    ckpt = str(root / "port_state.npz")
    with np.load(ckpt) as data:
        assert int(data["step"]) == 3
    resumed = _port().process_files(paths, checkpoint_path=ckpt, resume=True)
    assert resumed["rows"] == [r for r in port_run["rows"] if r["Frame"] >= 2]
    np.testing.assert_array_equal(resumed["som"], port_run["som"])


def test_jax_checkpoint_resumes_in_the_port(seq, jax_run):
    root, paths = seq
    resumed = _port().process_files(paths, resume=True,
                                    checkpoint_path=str(root / "jax_state.npz"))
    _assert_rows_match(resumed["rows"], [r for r in jax_run["rows"] if r["Frame"] >= 2])
    _assert_som_match(resumed["som"], jax_run["som"])


def test_q16_run_is_the_step_on_q16_points(seq):
    """``h2d_q16``: the runner hands the int16 points to ``preprocess`` (which
    dequantises them, bit-equal to JAX's: ``test_torch_gmfa_preprocess``) and
    keys the frames as the float32 run does (against JAX's q16 run:
    ``test_torch_gmfa_icp_drift``)."""
    _, paths = seq
    pipe = _port()
    got = pipe.process_files(paths[:2], h2d_q16=True)
    (q0, m0), (q1, m1) = DiskFrameSource(paths[:2], capacity=_CAPS["max_raw_points"],
                                         quantize_q16=True)
    assert q0.dtype == np.int16
    keys = [prng.split(prng.fold_in(prng.PRNGKey(0), i)) for i in range(2)]
    carry = pipe.seed_carry(*pipe.preprocess(torch.from_numpy(q0), torch.from_numpy(m0),
                                             keys[0][0]))
    carry, out = pipe.step(*pipe.preprocess(torch.from_numpy(q1), torch.from_numpy(m1),
                                            keys[1][0]), carry, keys[1][1])
    alive = carry.table.alive.numpy()
    assert not bool(out.skip) and alive.any()
    assert [(r["Frame"], r["Track ID"]) for r in got["rows"]] == \
        [(0, int(t)) for t in carry.table.tid.numpy()[alive]]
    np.testing.assert_array_equal([[r[c] for c in ("X", "Y", "VX", "VY")] for r in got["rows"]],
                                  carry.table.state.numpy()[alive])


def test_packed_observables_equal_jax_layout():
    """A frame's track-log observables pack to the JAX package's bytes."""
    jpack, jpacker = _cached_gmfa_obs_pack(JConfig(capacities=JCapacity(**_CAPS)), _MOVING,
                                           False)
    pack, packer = obs_packer(_cfg())
    assert packer.nbytes == jpacker.nbytes
    rng = np.random.default_rng(2)
    t = _CAPS["max_tracks"]
    table = {"state": rng.normal(size=(t, 4)).astype(np.float32),
             "cov": np.zeros((t, 4, 4), np.float32), "features": np.zeros((t, 4), np.float32),
             "tid": rng.integers(0, 100000, t).astype(np.int32),
             "age": np.ones(t, np.int32), "alive": rng.random(t) < 0.5}
    out = {"skip": np.array(False), "classifications": np.zeros(1, np.int32),
           "residuals": np.zeros(1, np.float32),
           "moving_points": np.zeros((_MOVING, 3), np.float32),
           "moving_count": np.array(1234, np.int32), "labels": np.zeros(_MOVING, np.int32),
           "n_clusters": np.array(7, np.int32), "transformation": np.eye(4, dtype=np.float32),
           "fitness": np.array(0.5, np.float32)}
    want = jpack(jgmfa.GmfaOutputs(**{n: jnp.asarray(v) for n, v in out.items()}),
                 jgmfa.TrackTableB(**{n: jnp.asarray(v) for n, v in table.items()}),
                 jnp.zeros((200, 200), jnp.float32))
    got = pack(GmfaOutputs(**{n: torch.as_tensor(v) for n, v in out.items()}),
               TrackTableB(**{n: torch.as_tensor(v) for n, v in table.items()}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    obs = packer.unpack(got.numpy())
    np.testing.assert_array_equal(obs["tid"], table["tid"])
    assert int(obs["moving_count"]) == 1234 and int(obs["n_clusters"]) == 7


def _reference_yaml(folder: str) -> dict:
    """A config in the reference's ``GMFA/config.yaml`` schema (the shape of
    pipeline A's file, read for ``roi_bounds``, ``dbscan_params`` and
    ``pcd_files``), with the native blocks for the test's small capacities."""
    return {"input_folder": folder, "output_folder": "gmfa_out",
            "grid_resolution": [0.2, 0.2], "x_range": [-20, 20], "y_range": [-20, 20],
            "z_max": 2.0, "roi_bounds": [-20, 20, -20, 20, -3, 3],
            "dbscan_params": {"eps": 1.0, "min_samples": 30},
            "icp": {"threshold": 0.2}, "capacities": dict(_CAPS)}


def test_load_config_b_matches_jax(tmp_path):
    for raw in (_reference_yaml("/data/pcds"), {"roi_bounds": [-10, 10, -10, 10, -2, 2],
                                                  "dbscan_params": {"eps": 4.0},
                                                  "pcd_files": ["b.pcd", "a.pcd"]}):
        path = tmp_path / "b.yaml"
        path.write_text(yaml.safe_dump(raw))
        got, want = load_config(str(path), "b"), jload_config(str(path), pipeline="b")
        assert isinstance(got, GMFAConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dbscan.min_samples == 1000  # the reference's executed value
    with pytest.raises(ValueError, match="unknown pipeline"):
        load_config(str(path), "c")


def test_cli_run_b_folder_and_yaml(seq, tmp_path, capsys, monkeypatch):
    root, paths = seq
    # a YAML config whose file list (taken as given, not sorted) is frames 1, 0
    raw = {**_reference_yaml(str(root / "seq")), "pcd_files": paths[1::-1]}
    path = tmp_path / "b.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "yaml" / "track_data.xlsx"
    os.makedirs(out.parent)
    assert cli(["run-b", str(path), "-o", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    with open(tmp_path / "yaml" / "track_data.csv", newline="") as f:
        got = list(csv.DictReader(f))
    assert f"{len(got)} track-log rows" in printed and len(got) > 0
    assert {int(r["Frame"]) for r in got} == {0}
    assert all(0 <= int(r["Track ID"]) < 100000 for r in got)

    # a folder with the default configuration (65,536 raw points, 81,920
    # expanded): one frame seeds the carry and the log has its header alone
    one = tmp_path / "one"
    os.makedirs(one)
    shutil.copy(paths[0], one)
    monkeypatch.chdir(tmp_path)
    assert cli(["run-b", str(one), "--device", "cpu"]) == 0
    assert "0 track-log rows" in capsys.readouterr().out
    with open(tmp_path / "track_data.csv", newline="") as f:
        assert list(csv.reader(f)) == [list(TRACK_LOG_COLUMNS)]


def test_cli_run_b_errors(tmp_path, capsys):
    os.makedirs(tmp_path / "empty")
    assert cli(["run-b", str(tmp_path / "empty"), "--device", "cpu"]) == 1
    assert "No PCD files found" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        cli(["run-b", str(tmp_path / "missing"), "--device", "cpu"])
    write_synthetic_sequence(SyntheticScene(ground_points=100, seed=1), str(tmp_path / "one"), 1)
    with pytest.raises(RuntimeError, match="CUDA|cuda"):  # the default device is the card
        cli(["run-b", str(tmp_path / "one")])
