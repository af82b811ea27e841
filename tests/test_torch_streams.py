"""The port's stream-parallel steps (``parallel/streams.py``) against the JAX
package's on conftest's CPU mesh (``stream_mesh(n)``), and each feed against
the port's single-stream step.

Tolerances: against JAX, those of ``tests/test_torch_pipeline_a.py`` for
pipeline A (velocity grids atol 1e-4, cell counts and labels exact, track
states atol 5e-3) and of ``tests/test_torch_gmfa_pipeline.py`` for GMFA
(transformation atol 1e-5, labels, moving counts and track ids exact, track
states atol 1e-4 + rtol 1e-5, the SOM atol 1e-6); the metric sums equal.
Against the port's single-stream step: every output and carry leaf equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import DbscanConfig as JDbscan
from datmo_using_optical_flow_tpu.config import GMFAConfig as JGConfig
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.parallel import streams as jstreams
from datmo_using_optical_flow_tpu.parallel.mesh import stream_mesh
from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig,
                                                       GMFAConfig, PipelineAConfig)
from datmo_using_optical_flow_tpu_torch.models.gmfa import GMFAPipeline
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.parallel import streams
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.tree import unstack
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs the CPU mesh")

# tests/test_parallel.py's configuration (a 200x200 grid)
_A_CAPS = dict(max_raw_points=2048, max_roi_points=512, max_cells=512, max_clusters=8,
               max_tracks=16)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for leaf in tree for x in _leaves(leaf)]
    return [tree]


def _assert_same(got, want):
    """Every leaf equal (NaN where NaN)."""
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert torch.equal(g, w) or (g.is_floating_point() and torch.equal(
            torch.nan_to_num(g, nan=1.5), torch.nan_to_num(w, nan=1.5))), (g, w)


def _bev_pairs(n, h, w):
    """Per stream two consecutive ``make_frames`` frames (seed = stream)."""
    frames = np.stack([make_frames(2, h, w, seed=s) for s in range(n)])
    return frames[:, 0], frames[:, 1]


def test_multi_stream_step_matches_jax_and_each_single_step():
    n = 4
    tcfg = PipelineAConfig(capacities=CapacityConfig(**_A_CAPS))
    jcfg = JConfig(capacities=JCapacity(**_A_CAPS))
    h, w = tcfg.grid_shape
    bev1, bev2 = _bev_pairs(n, h, w)
    jstep = jstreams.make_multi_stream_step(jcfg, stream_mesh(n), fast_warp=False)
    jcarry, jouts, jmetrics = jax.device_get(jstep(jnp.asarray(bev1), jnp.asarray(bev2),
                                                   jstreams.init_stream_carry(jcfg, n)))

    step = streams.make_multi_stream_step(tcfg, fast_warp=False, device="cpu")
    carry, outs, metrics = step(torch.from_numpy(bev1), torch.from_numpy(bev2),
                                streams.init_stream_carry(tcfg, n, "cpu"))
    np.testing.assert_allclose(outs.velocity_x.numpy(), jouts.velocity_x, atol=1e-4)
    np.testing.assert_allclose(outs.velocity_y.numpy(), jouts.velocity_y, atol=1e-4)
    for name in ("cell_count", "labels", "rows", "cols", "skip"):
        np.testing.assert_array_equal(getattr(outs, name).numpy(), getattr(jouts, name), name)
    np.testing.assert_array_equal(carry.table.alive.numpy(), jcarry.table.alive)
    np.testing.assert_allclose(carry.table.state.numpy(), jcarry.table.state, atol=5e-3)
    assert int(metrics["total_cells"]) == int(jmetrics["total_cells"]) > 0
    assert int(metrics["total_tracks"]) == int(jmetrics["total_tracks"])

    pipe = PipelineA(tcfg, "cpu", fast_warp=False)
    for s in range(n):
        c1, o1 = pipe.step(torch.from_numpy(bev1[s]), torch.from_numpy(bev2[s]),
                           pipe.init_carry())
        _assert_same(unstack(outs, s), o1)
        _assert_same(unstack(carry, s), c1)
    assert int(metrics["total_cells"]) == int(outs.cell_count.sum())
    assert int(metrics["total_tracks"]) == int(carry.table.alive.sum())


def test_stream_mode_step_is_each_feeds_step_stream():
    """The stream-mode step (``benchmarks/bench_multistream.py``'s): three
    frames for three feeds at 160x200, each feed equal to its own
    ``PipelineA.step_stream`` run."""
    n, h, w = 3, 160, 200
    cfg = PipelineAConfig(x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1),
                          grid_resolution=(0.1, 0.1),
                          capacities=CapacityConfig(max_cells=512, max_clusters=8,
                                                    max_tracks=16))
    frames = np.stack([make_frames(3, h, w, seed=s) for s in range(n)])
    step = streams.make_stream_mode_step(cfg, device="cpu")
    carry = streams.init_stream_mode_carry(cfg, n, "cpu")
    outs = []
    for t in range(3):
        carry, out, cells = step(torch.from_numpy(frames[:, t]), carry)
        outs.append(out)
        assert int(cells) == int(out.cell_count.sum())
    assert bool(outs[0].skip.all()) and not bool(outs[2].skip.any())
    pipe = PipelineA(cfg, "cpu")
    for s in range(n):
        c1 = pipe.init_stream_carry()
        for t in range(3):
            c1, o1 = pipe.step_stream(torch.from_numpy(frames[s, t]), c1)
            _assert_same(unstack(outs[t], s), o1)
        _assert_same(unstack(carry, s), c1)


def _gmfa_stream_clouds(n: int, p: int = 1024):
    """``tests/test_parallel.py``'s per-stream GMFA clouds: a static background
    and a cluster that moved 1.5 m between frames."""
    rng = np.random.default_rng(7)
    prev = np.empty((n, p, 3), np.float32)
    cur = np.empty((n, p, 3), np.float32)
    nbg = p - 128
    for s in range(n):
        bg = rng.uniform([-15, -15, 0.0], [15, 4.0, 1.5], size=(nbg, 3))
        c0 = np.array([-5.0 + s, -8.0 + 0.5 * s, 0.75])
        blob = rng.normal(scale=0.35, size=(128, 3)) + c0
        blob2 = blob + np.array([1.5, 0.4, 0.0])
        jitter = rng.normal(scale=0.004, size=(nbg, 3))
        prev[s] = np.concatenate([bg, blob])
        cur[s] = np.concatenate([bg + jitter, blob2])
    return prev, cur


def test_multi_stream_gmfa_step_matches_jax_and_each_single_step():
    n, p, max_moving = 2, 1024, 512
    caps = dict(max_raw_points=p, max_roi_points=128, expansion_factor=8, max_clusters=8,
                max_tracks=16)
    jcfg = JGConfig(dbscan=JDbscan(eps=1.0, min_samples=20), capacities=JCapacity(**caps))
    tcfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=20),
                      capacities=CapacityConfig(**caps))
    prev, cur = _gmfa_stream_clouds(n, p)
    mask = np.ones((n, p), bool)
    jkeys = jnp.stack([jax.random.PRNGKey(100 + s) for s in range(n)])

    jseed = jstreams.seed_gmfa_stream_carry(jstreams.init_gmfa_stream_carry(jcfg, n),
                                            jnp.asarray(prev), jnp.asarray(mask))
    jstep = jstreams.make_multi_stream_gmfa_step(jcfg, stream_mesh(n), max_moving=max_moving)
    jcarry, jouts, jmetrics = jax.device_get(jstep(jnp.asarray(cur), jnp.asarray(mask), jseed,
                                                   jkeys))

    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    carry = streams.seed_gmfa_stream_carry(streams.init_gmfa_stream_carry(tcfg, n, "cpu"),
                                           torch.from_numpy(prev), torch.from_numpy(mask))
    np.testing.assert_array_equal(carry.prev_order.numpy(), np.asarray(jseed.prev_order))
    step = streams.make_multi_stream_gmfa_step(tcfg, max_moving, "cpu")
    new_carry, outs, metrics = step(torch.from_numpy(cur), torch.from_numpy(mask), carry, keys)

    assert not bool(outs.skip.any()) and int(outs.n_clusters.min()) >= 1
    np.testing.assert_allclose(outs.transformation.numpy(), jouts.transformation, atol=1e-5)
    for name in ("labels", "moving_count", "classifications"):
        np.testing.assert_array_equal(getattr(outs, name).numpy(), getattr(jouts, name), name)
    np.testing.assert_array_equal(new_carry.prev_order.numpy(), jcarry.prev_order)
    np.testing.assert_array_equal(new_carry.table.tid.numpy(), jcarry.table.tid)
    np.testing.assert_array_equal(new_carry.table.alive.numpy(), jcarry.table.alive)
    np.testing.assert_allclose(new_carry.table.state.numpy(), jcarry.table.state, atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(new_carry.som.numpy(), jcarry.som, atol=1e-6, rtol=0)
    assert int(metrics["total_tracks"]) == int(jmetrics["total_tracks"]) > 0
    assert int(metrics["total_moving"]) == int(jmetrics["total_moving"]) > 0

    pipe = GMFAPipeline(tcfg, max_moving, "cpu")
    for s in range(n):
        c1 = pipe.seed_carry(torch.from_numpy(prev[s]), torch.from_numpy(mask[s]))
        c1, o1 = pipe.step(torch.from_numpy(cur[s]), torch.from_numpy(mask[s]), c1, keys[s])
        _assert_same(unstack(outs, s), o1)
        _assert_same(unstack(new_carry, s), c1)


def test_multistream_benchmark_is_the_jax_script():
    """``benchmarks/bench_multistream.py``'s workload: 4 streams at 1080x1920,
    ``bench.py``'s configuration, 9 frames, 3 repetitions; the card only."""
    from datmo_using_optical_flow_tpu_torch.benchmarks import multistream_4x1080p as ms

    assert (ms.N_STREAMS, ms.N_FRAMES, ms.REPS) == (4, 9, 3)
    assert (ms.H, ms.W) == (1080, 1920)
    assert ms.METRIC == "multistream_datmo_fps_4x1080p_single_chip"
    with pytest.raises(RuntimeError, match="card"):
        ms.run("cpu")
