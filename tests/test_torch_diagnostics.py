"""The port's diagnostics (``diagnostics/``), run here on the CPU at tiny
sizes, their byte and operation counts, and the runners' default device.

On the CPU a diagnostic's times come from the host clock and its device times
are ``None`` (not measured); the rows and counts are what these tests check.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu_torch.diagnostics import (icp_body, launch_count, micro_flow,
                                                            profile_1080p, roofline)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("kernel,args,nbytes,bound_us,bound_by", [
    ("poly_exp", (1080, 1920), 49_766_400, 14.8556, "bytes"),
    ("poly_exp", (324, 576), 4_478_976, 1.3370, "bytes"),
    ("poly_exp", (97, 173), 402_744, 0.12022, "bytes"),
    ("fused_iteration", (1080, 1920), 116_121_600, 34.6632, "bytes"),
    ("warp_matrices", (1080, 1920), 141_004_800, 42.0910, "bytes"),
    # 308 operations per pixel at 33.5e12/s outweigh its 28 bytes
    ("blur_solve", (97, 173), 469_868, 0.154285, "operations"),
    ("tiny", (1024,), 8_192, 0.0024454, "bytes"),
])
def test_roofline_counts_at_the_main_path_shapes(kernel, args, nbytes, bound_us, bound_by):
    work = getattr(roofline, kernel)(*args)
    assert work.bytes == nbytes
    assert work.bound_us() == pytest.approx(bound_us, rel=1e-4)
    assert work.bound_by() == bound_by


def test_roofline_operation_counts():
    px = 1080 * 1920
    assert roofline.poly_exp(1080, 1920).ops == 211 * px  # 61 vertical, 141 horizontal, 9
    assert roofline.blur_solve(1080, 1920, 15).ops == 308 * px
    assert roofline.fused_iteration(1080, 1920, 15).ops == (89 + 308) * px
    assert roofline.warp_matrices(1080, 1920).ops == 89 * px
    # K5: 400 blocks of 102,400 rows visiting 30 tiles each is bound by operations
    work = roofline.nearest_neighbors(102_400, 102_400, 400 * 30, 400)
    assert work.ops == 10 * 400 * 30 * 256 * 256
    assert work.bound_by() == "operations"
    assert work.bound_us() == pytest.approx(work.ops / 33.5e12 * 1e6)
    # the busiest block's 399 tiles on one SM, and split over a cluster of 8
    serial = roofline.nearest_neighbors_serial_us(399)
    assert serial == pytest.approx(399 * 10 * 256 * 256 / (33.5e12 / 132) * 1e6)
    assert roofline.nearest_neighbors_serial_us(399, 8) == pytest.approx(serial / 8)


def _moving_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(n, h, w) uint8 frames of a smooth random texture that moves 2 px down
    and 3 px right per frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2))
    xs = np.linspace(0, coarse.shape[1] - 1, w)
    ys = np.linspace(0, coarse.shape[0] - 1, h)
    rows = np.stack([np.interp(xs, np.arange(coarse.shape[1]), r) for r in coarse])
    tex = np.stack([np.interp(ys, np.arange(coarse.shape[0]), c) for c in rows.T], axis=1)
    return np.stack([np.roll(tex, (2 * t, 3 * t), axis=(0, 1)) for t in range(n)]).astype(np.uint8)


@pytest.fixture(scope="module")
def frames():
    return _moving_frames(2, 112, 160, seed=3)  # two pyramid levels


def _check_rows(res, names, keys):
    assert res["device"] == "cpu" and res["card"] == "cpu"
    assert [r["name"] for r in res["rows"]] == names
    for r in res["rows"]:
        for k in keys:
            assert k in r, (r["name"], k)


def test_micro_flow_runs_every_row():
    """Three pyramid levels (360x384, 108x115, 32x35), as at 1080p: K1 has a
    row at each."""
    res = micro_flow.run(_moving_frames(2, 360, 384, seed=3), device="cpu", reps=1)
    _check_rows(res, ["K3 fused_iteration 360x384",
                      "K3 fused_iteration 360x384, Gaussian window", "K4 warp_matrices 360x384",
                      "K2 blur_solve on K4's M 360x384",
                      "update_matrices packed (plain) 360x384",
                      "K3 fused_iteration 108x115, second level",
                      "K2 blur_solve on packed M 32x35, coarsest level",
                      "K1 poly_exp 360x384", "K1 poly_exp 108x115", "K1 poly_exp 32x35"],
                ("ms", "device_us", "bytes", "ops", "bound_us", "bound_by", "share_of_bound"))
    for r in res["rows"]:
        assert r["ms"] > 0 and r["bytes"] > 0 and r["bound_us"] > 0
        assert r["device_us"] is None and r["share_of_bound"] is None  # not measured here
    assert res["rows"][2]["bytes"] == roofline.warp_matrices(360, 384).bytes
    assert res["rows"][-1]["bytes"] == roofline.poly_exp(32, 35).bytes
    assert res["parent"] is None and "parent_device_us" not in res["rows"][0]


def test_profile_1080p_runs_every_stage(frames):
    res = profile_1080p.run(frames, device="cpu", reps=1, max_cells=256)
    _check_rows(res, ["full stream step", "flow_from_pyramids (all levels)",
                      "K4 warp_matrices, finest level, real flow",
                      "K4 warp_matrices, finest level, zero flow",
                      "K3 fused_iteration, finest level, real flow",
                      "K3 fused_iteration, finest level, zero flow",
                      "DATMO tail (masks, DBSCAN, tracker)",
                      "flow of the levels below the finest", "build_pyramid (all levels)"],
                ("ms", "device_ms", "busy_share"))
    assert all(r["ms"] > 0 and r["device_ms"] is None for r in res["rows"])


def test_launch_count_runs_both_rows_on_the_cpu():
    """``launch_count`` times the stream step and the pyramid; on the CPU it
    measures no device records (nothing runs on a device)."""
    rec = launch_count.run(256, 320, "cpu", traces=1)
    assert rec["card"] == "cpu" and rec["shape"] == [256, 320]
    assert set(rec["rows"]) == {"stream step", "build_pyramid"}
    assert all(r["host_ms"] > 0 and r["device_records"] is None for r in rec["rows"].values())


def test_icp_body_runs_every_part_and_the_tile_probe():
    res = icp_body.run(*icp_body.clouds(2048), device="cpu", steps=3, reps=1,
                       threshold=0.2, max_iterations=5)
    _check_rows(res, ["carry arithmetic only", "kabsch + host SVD (fixed correspondences)",
                      "kabsch tree sums only (no host copy)", "eval_cached algebra (no K5)",
                      "stable partition + scatter + gathers", "one K6 launch (tiny) per step"],
                ("ms_total", "ms_per_step", "device_ms_total"))
    probe = res["tile_probe"]
    first = probe["rounds"]["first"]
    assert first["round"] == 0 and first["active_rows"] == 2048 and first["live_blocks"] == 8
    assert 1 <= first["visits_median"] <= first["visits_max"] <= first["tiles"] == 8
    assert first["ops"] == 10 * first["visits_total"] * 256 * 256
    assert probe["active_rows_per_round"][0] == 2048 and probe["iterations"] >= 2
    active = probe["rounds"]["active"]
    assert active["round"] >= 1 and active["active_rows"] > 0


def test_icp_body_times_a_parent_checkout_in_turns():
    """The repo itself as the parent: its ``ops/icp.py`` loads as a module of
    its own, and each compared part gets one row with both times."""
    root = Path(__file__).resolve().parents[1]
    assert icp_body.parent_icp(root) is not icp_body.icp
    res = icp_body.run(*icp_body.clouds(1024), device="cpu", steps=2, reps=1, threshold=0.2,
                       max_iterations=3, parent=root)
    compared = res["rows"][6:]
    assert [r["name"] for r in compared] == ["transform_points (1024 points)",
                                             "eval_cached algebra (no K5), moved",
                                             "registration_icp cached (3 rounds)"]
    for r in compared:
        assert r["ms_total"] > 0 and r["parent_ms_total"] > 0
        assert [len(r["turns"][k]) for k in ("package", "parent")] == [2, 2]
    assert res["parent"] == str(root)


def test_tile_visits_leave_the_outputs_alone():
    """The probe reads the plain sweep's visits; its outputs are the plain
    version's, so reading the visits changes nothing."""
    from datmo_using_optical_flow_tpu_torch.ops import nn_kernels

    rng = np.random.default_rng(5)
    src = torch.as_tensor(rng.uniform(-5, 5, (700, 3)).astype(np.float32))
    tgt = torch.as_tensor(rng.uniform(-5, 5, (900, 3)).astype(np.float32))
    index = nn_kernels.build_target_index(tgt, torch.ones(900, dtype=torch.bool))
    want = nn_kernels.nearest_neighbors_reference(src, index, 600, 0.25)
    got, visits = nn_kernels.nearest_neighbors_reference_visits(src, index, 600, 0.25)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert visits.shape == (3,) and int(visits[2]) >= 1  # 600 active rows: 3 live blocks
    assert bool((visits <= index.packed.shape[0]).all())
    assert int(nn_kernels.nearest_neighbors_reference_visits(src, index, 256)[1][1]) == 0


def test_runners_default_to_the_card():
    """With no device the runners ask for CUDA, which raises where it is absent."""
    from datmo_using_optical_flow_tpu_torch.config import PipelineAConfig
    from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA

    if torch.cuda.is_available():
        assert GMFAPipeline().device.type == "cuda"
        assert PipelineA(PipelineAConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        GMFAPipeline()
    with pytest.raises(RuntimeError, match="cuda"):
        PipelineA(PipelineAConfig())
    assert GMFAPipeline(device="cpu").device.type == "cpu"
    assert PipelineA(PipelineAConfig(), "cpu").device.type == "cpu"


def test_diagnostics_ask_for_the_card_by_default(frames):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        micro_flow.run(frames)


def test_micro_flow_builds_the_parent_only_for_the_card(frames, tmp_path):
    with pytest.raises(RuntimeError, match="card"):
        micro_flow.run(frames, device="cpu", parent=tmp_path)


def test_against_parent_refuses_a_build_that_differs():
    """Both builds are held to the plain version bit for bit before either is
    timed: a parent one ulp off in one pixel is refused."""
    a = torch.linspace(0, 1, 12).reshape(3, 4)
    off = a.clone()
    off[1, 2] = torch.nextafter(off[1, 2], torch.tensor(2.0))
    work = roofline.blur_solve(3, 4, 15)
    with pytest.raises(AssertionError, match="the parent differs"):
        micro_flow.against_parent(lambda: (a, a), lambda: (a, off), lambda: (a, a.clone()), work,
                                  torch.device("cpu"), "cpu")
    with pytest.raises(AssertionError, match="this build differs"):
        micro_flow.against_parent(lambda: (off, a), lambda: (a, a), lambda: (a, a), work,
                                  torch.device("cpu"), "cpu")


def test_stage_row_reports_a_lost_trace_as_not_measured(monkeypatch, capsys):
    """A stage's device time whose profiler traces keep losing kernel records
    is not measured (None), and the row says so; the stage's ms stands."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    def lost(fn, dev, reps=5, launches=1):
        raise measure.LostTrace("the profiler lost kernel records in 3 traces on the card")

    monkeypatch.setattr(measure, "device_us_per_call", lost)
    row = measure.stage_row("a stage", lambda: torch.ones(4).sum(), torch.device("cpu"), "cpu",
                            reps=1)
    assert row["ms"] > 0 and row["device_ms"] is None and row["busy_share"] is None
    assert "a stage: device time not measured" in capsys.readouterr().out


def _trace(*calls, head=8, tail=8):
    """Kernel records ``(name, µs)`` as :func:`measure.device_us_per_call`
    lays a trace out: sentinels, the calls with one sentinel between each
    two, sentinels."""
    s = ("void at::native::spin_kernel(long)", 0.5)
    out = [s] * head
    for i, call in enumerate(calls):
        out += ([s] if i else []) + [("datmo_blur_solve", us) for us in call]
    return out + [s] * tail


@pytest.mark.parametrize("calls, head, tail, launches, want", [
    (([2.0], [4.0], [3.0]), 8, 8, 1, 3.0),
    (([2.0], [4.0], [3.0]), 1, 8, 1, 3.0),
    (([2.0, 1.0], [4.0, 2.0]), 8, 8, 2, 4.5),
    (([], [], []), 8, 8, 0, 0.0),
    (([2.0], [], [3.0]), 8, 8, 1, None),
    (([], [], []), 8, 8, 1, None),
    (([2.0], [4.0], [3.0]), 0, 8, 1, None),
    (([2.0], [4.0], [3.0]), 8, 0, 1, None),
    (([], [], []), 0, 8, 0, None),
    (([2.0], [0.0], [3.0]), 8, 8, 1, None),
    (([2.0, 1.0], [4.0], [3.0, 1.0]), 8, 8, 2, None),
    (([2.0], [4.0], [3.0]), 9, 8, 1, None),
])
def test_traced_us_refuses_a_trace_that_lost_records(calls, head, tail, launches, want):
    """Device time is read from a trace only when its ends are sentinels and
    every call left its kernels; the opening sentinels may lose records (the
    H100's traces lose their first ones: ``S6 K1 S1 K1 S1 K1 S8`` in
    chip_smoke), a call or a closing sentinel may not."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    got = measure.traced_us(_trace(*calls, head=head, tail=tail), len(calls), launches)
    assert got == want


def test_traced_us_refuses_a_trace_left_with_its_closing_sentinels():
    """A trace that lost its opening sentinels and every call, keeping only
    the closing sentinels, is lost, not 0 µs (K2's five calls once read 0 µs
    on the H100 so, and chip_smoke divided by it)."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    closing = _trace([1.0], [1.0], [1.0], [1.0], [1.0])[-5:]
    assert [name for name, _ in closing] == ["void at::native::spin_kernel(long)"] * 5
    assert measure.traced_us(closing, 5, 1) is None
    assert measure.trace_layout(closing) == "S5"
    assert measure.trace_layout(_trace([2.0], [0.0], head=6)) == "S6 K1 S1 01 S8"


def test_sweep_ab_times_both_sweeps_on_the_cpu():
    """The compact/in-place comparison at a small size: both sweeps reach the
    uncached loop's transform here, their busiest rounds are read from the
    plain sweep, and the device times are not measured on the CPU."""
    rng = np.random.default_rng(11)
    src = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    c, s = np.cos(0.01), np.sin(0.01)
    dst = (src @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32).T
           + np.float32([0.05, -0.03, 0.01]) + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    mask = torch.ones(3000, dtype=torch.bool)
    res = icp_body.sweep_ab(torch.from_numpy(src), mask, torch.from_numpy(dst), mask, 0.05, 30,
                            "cpu", reps=1)
    for sweep in ("compact", "inplace"):
        row = res[sweep]
        assert row["ms"] > 0 and row["k5_launches"] >= 1 and row["k5_device_ms"] is None
        assert row["vs_uncached"] < 1e-5
        rnd = row["busiest_round"]
        assert rnd["k5_us"] is None and 1 <= rnd["visits_max"] <= rnd["tiles"]
    assert res["inplace_vs_compact"] < 1e-5


def test_sweep_ab_reports_a_lost_trace_as_not_measured(monkeypatch):
    """A device time whose profiler traces were lost reads None, and says so,
    where ``measure.device_us_per_call`` gave up."""
    def lost(*args, **kwargs):
        raise icp_body.LostTrace("the profiler lost kernel records in 5 traces on the card")

    monkeypatch.setattr(icp_body, "device_us_per_call", lost)
    assert icp_body._device_us(lambda: None, torch.device("cuda"), reps=1) is None
