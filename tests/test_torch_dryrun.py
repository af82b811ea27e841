"""The port's dry run (``dryrun.py``) on a 4-rank gloo group of CPU
processes at reduced sizes: the four multi-rank paths (stream-parallel A at
the 200x200 production grid, the row-sharded flow at 128x160, stream-parallel
GMFA at 512 points per feed, 2 feeds x 2 row ranks), each held by the dry run
itself to the unsharded computation with the JAX dry run's tolerances; here
also the report's contents.  ``entry`` runs one stream step.  Phase 4's
frame pairs also go through pipeline A's packed step against JAX's.  The
full sizes run in ``test_torch_dryrun_full.py`` (slow).
"""

import pytest
import torch

from datmo_using_optical_flow_tpu_torch import dryrun
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def report():
    return dryrun.dryrun_multichip(4, "gloo", "cpu", flow_hw=(128, 160), points=512, reps=1,
                                   timeout=300)


def test_every_phase_passes(report):
    p1, p2, p3, p4 = (report[f"phase{i}"] for i in (1, 2, 3, 4))
    assert p1["grid"] == [200, 200] and p1["velocity_err"] <= 1e-5 and p1["total_cells"] > 0
    assert p2["shape"] == [128, 160] and p2["rows_per_rank"] == 32 and p2["max_epe"] < 1e-3
    assert p3["transform_err"] <= 1e-5 and p3["state_err"] <= 1e-4
    assert p3["total_moving"] > 0 and p3["total_tracks"] > 0
    assert (p4["streams"], p4["space_ranks"]) == (2, 2)
    assert p4["cells"] > 0
    for warp in ("packed", "exact"):  # the production step's warp, and the sharded flow's
        assert p4[warp]["velocity_err"] <= 5e-3 and p4[warp]["state_err"] <= 1e-3
    # the sharded level on the ranks' device against the CPU's, after each
    # iteration (both on the CPU here; the card's on the card)
    assert report["level_iterations"] == [0] * dryrun.LEVEL_ITERATIONS


def test_every_rank_reports_and_launches_nothing_on_the_cpu(report):
    """On CPU tensors every wrapper takes its plain version: no rank counts a
    launch on any path; each rank timed its sharded flow."""
    assert [r["rank"] for r in report["per_rank"]] == [0, 1, 2, 3]
    for r in report["per_rank"]:
        assert set(r["launches"]) == {"stream_a", "sharded_flow", "stream_gmfa",
                                      "stream_space"}
        assert all(c == {} for c in r["launches"].values())
        assert r["sharded_ms"] > 0
    assert report["unsharded_ms"] > 0 and "kernel_checks" not in report


def test_entry_runs_the_stream_step():
    fn, (bev, carry) = dryrun.entry("cpu")
    assert tuple(bev.shape) == (200, 200) and bev.dtype == torch.uint8
    new_carry, out = fn(bev, carry)
    assert bool(out.skip)  # the priming frame
    assert tuple(out.velocity_x.shape) == (200, 200)
    _, out2 = fn(bev, new_carry)
    assert not bool(out2.skip)


@pytest.mark.parametrize("seed", [20, 21])  # phase 4's two feeds
def test_packed_step_matches_jax_on_phase4_frames(seed):
    """Phase 4's frame pairs through pipeline A's packed-warp step, the port's
    against JAX's compiled step (``use_pallas=False``, as JAX's dry run):
    velocity to 1e-5 m/s, cells equal.  A few ulps of the pyramid once moved
    an int8 corner of the packed table and parted them by 6.9e-3 m/s."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from datmo_using_optical_flow_tpu.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow_tpu.models import optical_flow_datmo as jdatmo
    from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames

    jcfg = PipelineAConfig(capacities=CapacityConfig(
        max_raw_points=4096, max_roi_points=1024, max_cells=2048, max_clusters=16,
        max_tracks=32))
    f1, f2 = make_frames(2, 200, 200, seed=seed, n_objects=3)
    _, want = jax.jit(lambda a, b, c: jdatmo._step_impl(a, b, c, cfg=jcfg, fast_warp=True,
                                                       use_pallas=False))(
        jnp.asarray(f1), jnp.asarray(f2), jdatmo.PipelineA(jcfg).init_carry())
    pipe = PipelineA(dryrun.prod_cfg(), "cpu", fast_warp=True)
    _, got = pipe.step(torch.from_numpy(f1), torch.from_numpy(f2), pipe.init_carry())
    np.testing.assert_allclose(got.velocity_x.numpy(), np.asarray(want.velocity_x), atol=1e-5)
    assert int(got.cell_count) == int(want.cell_count)


@pytest.mark.parametrize("n,backend,device", [(3, "gloo", "cpu"), (4, "nccl", "cpu")])
def test_unsupported_layouts_raise(n, backend, device):
    with pytest.raises(ValueError):
        dryrun.dryrun_multichip(n, backend, device)
