"""The slice end to end: the port's pipeline-A stream step against the JAX
package's (``PipelineA(cfg, fast_warp=True, use_pallas=True)``, as ``bench.py``
runs it), four ``bench.make_frames`` frames at 256x320 with the grid set to the
frame shape.  Also: stream mode equals pair mode, and a JAX carry continued by
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_frames
from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.models.optical_flow_datmo import PipelineA as JPipelineA
from datmo_using_optical_flow_tpu.ops import warp_pallas
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.utils.state import carry_from_numpy, carry_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 256, 320
_KW = dict(x_range=(0.0, H * 0.1), y_range=(0.0, W * 0.1), grid_resolution=(0.1, 0.1))
_CAP = dict(max_cells=1024, max_clusters=32, max_tracks=64)


@pytest.fixture(scope="module")
def frames():
    return make_frames(4, H, W)


@pytest.fixture(scope="module")
def cfg():
    c = PipelineAConfig(capacities=CapacityConfig(**_CAP), **_KW)
    assert c.grid_shape == (H, W)
    return c


@pytest.fixture(scope="module")
def jax_run(frames):
    """JAX stream outputs and the carry after each frame (host copies)."""
    pipe = JPipelineA(JConfig(capacities=JCapacity(**_CAP), **_KW), fast_warp=True,
                      use_pallas=True)
    carry = pipe.init_stream_carry()
    outs, carries = [], []
    for f in frames:
        carry, out = pipe.step_stream(jnp.asarray(f), carry)
        outs.append(jax.device_get(out))
        carries.append(jax.device_get(carry))
    return outs, carries


def _port_run(pipe, frames, carry):
    outs = []
    for f in frames:
        carry, out = pipe.step_stream(torch.as_tensor(f), carry)
        outs.append(out)
    return outs, carry


def _assert_pair(got, want, track_atol):
    """Velocity grids atol 1e-4, cells exact, tracks at ``track_atol``."""
    for name in ("velocity_x", "velocity_y", "raw_velocity_x", "raw_velocity_y", "magnitude"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), atol=1e-4,
                                   err_msg=name)
    assert int(got.cell_count) == int(want.cell_count)
    assert bool(got.cell_overflow) == bool(want.cell_overflow)
    for name in ("rows", "cols", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), name)
    for name in ("tid", "alive", "lifetime", "confirmed"):
        np.testing.assert_array_equal(getattr(got.snapshot, name).numpy(),
                                      getattr(want.snapshot, name), name)
    np.testing.assert_allclose(got.snapshot.state.numpy(), want.snapshot.state, atol=track_atol)


def test_stream_step_matches_jax(cfg, frames, jax_run):
    jouts, _ = jax_run
    pipe = PipelineA(cfg, "cpu", fast_warp=True)
    outs, _ = _port_run(pipe, frames, pipe.init_stream_carry())
    assert bool(outs[0].skip) and bool(jouts[0].skip)  # the priming frame
    for i in range(1, len(frames)):
        got, want = outs[i], jouts[i]
        assert not bool(got.skip) and not bool(want.skip)
        _assert_pair(got, want, track_atol=5e-3)
        assert int(got.cell_count) > 0 and int(got.snapshot.alive.sum()) > 0
        # the eligible level's flow stays in the JAX kernel's warp window, so
        # JAX compared its exact fused warp, not its quantized fallback
        px = _KW["x_range"][1] / W  # velocity = flow * pixel size
        assert bool(warp_pallas.flow_in_range(jnp.asarray(want.raw_velocity_x / px),
                                              jnp.asarray(want.raw_velocity_y / px)))


def test_stream_mode_matches_pair_mode(cfg, frames):
    """step_stream (pyramid carried across frames) equals pair-mode step over
    consecutive frames, including the zero-frame skip and recovery."""
    pipe = PipelineA(cfg, "cpu")
    pair_carry = pipe.init_carry()
    stream_carry, out0 = pipe.step_stream(torch.as_tensor(frames[0]), pipe.init_stream_carry())
    assert bool(out0.skip)
    for i in range(1, len(frames)):
        a, b = torch.as_tensor(frames[i - 1]), torch.as_tensor(frames[i])
        pair_carry, pout = pipe.step(a, b, pair_carry)
        stream_carry, sout = pipe.step_stream(b, stream_carry)
        assert bool(pout.skip) == bool(sout.skip)
        np.testing.assert_allclose(sout.velocity_x.numpy(), pout.velocity_x.numpy(), atol=1e-5)
        np.testing.assert_array_equal(sout.labels.numpy(), pout.labels.numpy())
        np.testing.assert_allclose(stream_carry.step.table.state.numpy(),
                                   pair_carry.table.state.numpy(), atol=1e-4)

    # a zero frame mid-stream: this pair AND the next are skipped, state kept
    kept = carry_to_numpy(stream_carry.step)
    stream_carry, out_z = pipe.step_stream(torch.zeros((H, W), dtype=torch.uint8), stream_carry)
    assert bool(out_z.skip)
    stream_carry, out_after = pipe.step_stream(torch.as_tensor(frames[0]), stream_carry)
    assert bool(out_after.skip)
    for a, b in zip(jax.tree.leaves(tuple(carry_to_numpy(stream_carry.step))),
                    jax.tree.leaves(tuple(kept))):
        np.testing.assert_array_equal(a, b)
    stream_carry, out_ok = pipe.step_stream(torch.as_tensor(frames[1]), stream_carry)
    assert not bool(out_ok.skip)


def test_scan_steps_matches_stream_loop(cfg, frames):
    pipe = PipelineA(cfg, "cpu")
    final, stacked = pipe.scan_steps(torch.as_tensor(frames), pipe.init_carry())
    outs, carry = _port_run(pipe, frames, pipe.init_stream_carry())
    assert stacked.velocity_x.shape == (len(frames) - 1, H, W)
    for i, out in enumerate(outs[1:]):
        np.testing.assert_array_equal(stacked.velocity_x[i].numpy(), out.velocity_x.numpy())
        np.testing.assert_array_equal(stacked.labels[i].numpy(), out.labels.numpy())
    np.testing.assert_array_equal(final.table.state.numpy(), carry.step.table.state.numpy())


def test_jax_carry_continues_in_the_port(cfg, frames, jax_run):
    """Start the port from JAX's carry after two frames: the third frame's
    outputs match JAX's, and the carry round-trips through numpy."""
    jouts, jcarries = jax_run
    carry = carry_from_numpy(jcarries[1], "cpu")
    assert isinstance(carry.pyr, tuple) and carry.step.table.tid.dtype == torch.int32
    for a, b in zip(jax.tree.leaves(tuple(carry_to_numpy(carry))),
                    jax.tree.leaves(tuple(jcarries[1]))):
        np.testing.assert_array_equal(a, b)
    carry, out = PipelineA(cfg, "cpu").step_stream(torch.as_tensor(frames[2]), carry)
    _assert_pair(out, jouts[2], track_atol=1e-5)
    np.testing.assert_allclose(carry.step.table.state.numpy(), jcarries[2].step.table.state,
                               atol=1e-5)
