"""The port's diagnostics (``diagnostics/``), run here on the CPU at tiny
sizes, their byte and operation counts, and the runners' default device.

On the CPU a diagnostic's times come from the host clock and its device times
are ``None`` (not measured); the rows and counts are what these tests check.
"""

import sys
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
    # K9 reads R0, R1 and the flow and writes M: 68 bytes a pixel, no table
    ("warp_packed", (97, 173), 1_141_108, 0.340629, "bytes"),
    ("warp_packed", (1080, 1920), 141_004_800, 42.0910, "bytes"),
    # its scale pass reads R1 once and writes five scales
    ("corner_scale", (97, 173), 335_640, 0.100191, "bytes"),
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
    assert roofline.fused_iteration(1080, 1920, 15).ops == (99 + 308) * px
    assert roofline.warp_matrices(1080, 1920).ops == 99 * px  # an fma counted as two
    # and the packed scales, and 20 corners quantised (divide, round, clamp)
    assert roofline.warp_packed(1080, 1920).ops == 189 * px
    assert roofline.corner_scale(1080, 1920).ops == 10 * px   # |v| and the maximum
    # between iterations K3 reads and writes the numerators and 1 / det
    assert roofline.fused_iteration(1080, 1920, 15, 3, 3).bytes == 64 * px
    # ... and K4 reads them, K2 writes them; a sharded block's K4 reads R1's halo
    assert roofline.warp_matrices(1080, 1920, 3).bytes == 72 * px
    assert roofline.blur_solve(1080, 1920, 15, 3).bytes == 32 * px
    assert roofline.warp_matrices(272, 1920, 2, 16).bytes == 68 * 272 * 1920 + 20 * 32 * 1920
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
                      "K3 fused_iteration 360x384, Gaussian window",
                      "K3 fused_iteration 360x384, (nx, ny, 1/det) in and out",
                      "K4 warp_matrices 360x384",
                      "K2 blur_solve on K4's M 360x384",
                      "K9 warp_matrices_packed 360x384",
                      "K3 fused_iteration 108x115, second level",
                      "K2 blur_solve on K9's M 32x35, coarsest level",
                      "K9 warp_matrices_packed 32x35, coarsest level",
                      "K1 poly_exp 360x384", "K1 poly_exp 108x115", "K1 poly_exp 32x35"],
                ("ms", "device_us", "bytes", "ops", "bound_us", "bound_by", "share_of_bound"))
    for r in res["rows"]:
        assert r["ms"] > 0 and r["bytes"] > 0 and r["bound_us"] > 0
        assert r["device_us"] is None and r["share_of_bound"] is None  # not measured here
    assert res["rows"][3]["bytes"] == roofline.warp_matrices(360, 384).bytes
    assert res["rows"][5]["bytes"] == roofline.warp_packed(360, 384).bytes
    assert res["rows"][-1]["bytes"] == roofline.poly_exp(32, 35).bytes
    assert res["parent"] is None and "parent_device_us" not in res["rows"][0]


def test_micro_flow_k4_runs_every_row():
    """``--k4`` at a dry shape on the CPU: a 42x42 coarsest level of 140x140
    frames, both windows, the old route (K4 then K2) and the route through
    K3 bit-equal to each other and to the plain versions, each with its
    bound; K4, K2 and K3 alone; K4 on rank 0's and rank 1's blocks of a
    32x48 grid over 4 ranks, with its launches per sharded flow call (its
    device time, warm or with L2 cleared, not measured here)."""
    res = micro_flow.k4_rows(torch.device("cpu"), "cpu", levels=((140, 140, 42, 42),),
                             sharded=(8, 48, 4, 4), reps=1, rounds=1)
    assert res["card"] == "cpu" and res["parent"] is None
    assert [r["name"] for r in res["levels"]] == ["exact level 42x42 box",
                                                  "exact level 42x42 Gaussian"]
    for r in res["levels"]:
        assert r["launches"] == {}  # the CPU runs the plain versions
        for route in ("k4_k2", "route"):
            assert r[route]["ms"] > 0 and r[route]["device_us"] is None
            assert r[route]["records"] is None and r[route]["bound_us"] > 0
        # M is neither stored nor reloaded: 40 bytes a pixel fewer per iteration
        assert r["k4_k2"]["bound_us"] > r["route"]["bound_us"]
    assert [r["name"] for r in res["kernels"]] == ["K4 42x42 alone", "K2 42x42 alone",
                                                   "K3 42x42 alone"]
    assert [r["launches_per_level_after"] for r in res["kernels"]] == [0, 0, 5]
    assert [r["rank"] for r in res["sharded"]] == [0, 1]
    for r in res["sharded"]:
        assert r["launches_per_sharded_call"] == 5  # level 0's 5 iterations
        assert r["bytes"] == roofline.warp_matrices(8, 48, 2, 4).bytes
        assert r["device_us_cold_l2"] is None and r["share_of_bound_cold_l2"] is None


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


def test_against_parent_refuses_a_build_that_differs(monkeypatch):
    """Before either build is timed, this build is held to the plain version
    bit for bit (one ulp off in one pixel is refused) and the parent within
    1e-4 of its scale (a parent may round otherwise: its difference is
    reported; one far off is refused)."""
    monkeypatch.setattr(micro_flow, "device_us_per_call", lambda fn, dev, reps=5, launches=1: 1.0)
    a = torch.linspace(0, 1, 12).reshape(3, 4)
    off = a.clone()
    off[1, 2] = torch.nextafter(off[1, 2], torch.tensor(2.0))
    work = roofline.blur_solve(3, 4, 15)
    with pytest.raises(AssertionError, match="this build differs"):
        micro_flow.against_parent(lambda: (off, a), lambda: (a, a), lambda: (a, a), work,
                                  torch.device("cpu"), "cpu")
    with pytest.raises(AssertionError, match="the parent differs"):
        micro_flow.against_parent(lambda: (a, a), lambda: (a, a + 1e-3), lambda: (a, a.clone()),
                                  work, torch.device("cpu"), "cpu")
    row = micro_flow.against_parent(lambda: (a, a), lambda: (a, off), lambda: (a, a.clone()),
                                    work, torch.device("cpu"), "cpu")
    assert row["parent_max_abs_diff"] == float(off[1, 2] - a[1, 2]) > 0


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


@pytest.mark.parametrize("given,kept", [(None, "0"), ("1", "1")])
def test_measure_keeps_cupti_between_traces_unless_told(given, kept):
    """Importing ``measure`` sets ``TEARDOWN_CUPTI=0`` (kineto otherwise tears
    CUPTI down after each trace and the card's traces come back empty), and
    leaves a value the caller set."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    if given is not None:
        env["TEARDOWN_CUPTI"] = given
    code = ("import os; import datmo_using_optical_flow_tpu_torch.diagnostics.measure; "
            "print(os.environ['TEARDOWN_CUPTI'])")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == kept


def test_profiler_traces_needs_the_card(monkeypatch):
    from datmo_using_optical_flow_tpu_torch.diagnostics import profiler_traces

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler_traces.run(traces=1)


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


@pytest.mark.parametrize("lost, counted, layout, want", [
    (0, 0, "S8 K1 S1 K1 S1 K1 S8", 3.0),
    (20, 20, "S8 K1 S1 K1 S1 K1 S8", 3.0),
    (248, 248, "S8 K1 S1 K1 S1 K1 S8", 3.0),
    (255, 255, "S1 K1 S1 K1 S1 K1 S8", 3.0),
    (256, 256, "K1 S1 K1 S1 K1 S8", None),
    # the first call's kernel lost too: the separator opens the trace
    (257, 255, "S1 K1 S1 K1 S8", None),
])
def test_trim_lead_reads_a_trace_through_its_lost_opening(lost, counted, layout, want):
    """A trace opens with ``_LEAD + _SENTINELS`` sentinels, of which the card
    loses more the more traces a process has taken; :func:`measure.trim_lead`
    keeps the last ``_SENTINELS`` that survived, so the trace is read while
    one survives, and refused once the calls' records are lost too."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    opening = measure._LEAD + measure._SENTINELS
    records = _trace([2.0], [4.0], [3.0], head=opening)[lost:]
    assert measure.head_lost(records) == counted
    assert measure.trace_layout(measure.trim_lead(records)) == layout
    assert measure.traced_us(measure.trim_lead(records), 3, 1) == want


_FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
_K4 = "void warp_matrices_kernel<false>(float const*, float const*, FlowIn, float*, int, int)"


def _named(trace, names):
    """``trace`` with its calls' records renamed, in order, to ``names``."""
    it = iter(names)
    return [(name if "spin_kernel" in name else next(it), us) for name, us in trace]


def test_named_us_reads_one_kernel_of_each_call():
    """With L2 cleared before each call (:func:`measure.cold_kernel_us`) a
    call is a fill, then the kernel; :func:`measure.named_us` reads the
    kernel's records alone, and refuses a trace that lost a record or holds
    the kernel other than once a call."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    calls = ([40.0, 9.0], [41.0, 10.0], [39.0, 11.0])
    trace = _named(_trace(*calls), [_FILL, _K4] * 3)
    assert measure.named_us(trace, 3, 2, "warp_matrices_kernel") == 10.0
    assert measure.named_us(trace, 3, 2, "FillFunctor") == 40.0
    assert measure.named_us(trace, 3, 2, "blur_solve_kernel") is None
    lost = _named(_trace([40.0, 9.0], [41.0], [39.0, 11.0]), [_FILL, _K4, _FILL, _FILL, _K4])
    assert measure.named_us(lost, 3, 2, "warp_matrices_kernel") is None
    twice = _named(_trace([9.0, 9.0], [41.0, 10.0], [39.0, 11.0]), [_K4, _K4, _FILL, _K4] * 2)
    assert measure.named_us(twice, 3, 2, "warp_matrices_kernel") is None
    assert measure.cold_kernel_us(lambda: None, torch.device("cpu"), "warp_matrices_kernel") \
        is None


def test_trim_lead_leaves_a_trace_without_lead_in_as_it_is():
    from datmo_using_optical_flow_tpu_torch.diagnostics import measure

    records = _trace([2.0], [4.0], [3.0], head=5)
    assert measure.trim_lead(records) == records
    assert measure.trim_lead([]) == []
    assert measure.head_lost(records) == measure._LEAD + measure._SENTINELS - 5


def test_profiler_traces_head_loss_needs_the_card(monkeypatch):
    from datmo_using_optical_flow_tpu_torch.diagnostics import profiler_traces

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["profiler_traces", "--head-loss", "--traces", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler_traces.main()


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
