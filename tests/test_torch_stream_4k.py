"""Pipeline A's stream step at a width above 2048, the port against the JAX
package's ``PipelineA(..., use_pallas=True)``, three ``make_frames`` frames at
160x2176 (levels 160x2176 and 48x653).

Above 2048 columns the JAX package takes its XLA path on level 0 (the TPU
kernels' VMEM limit), with the packed warp when ``fast_warp`` is set, and
its kernel path on the coarse level, which packs there whatever the flag.
The port warps level 0 exactly (K3) and packs the coarse level with
``fast_warp``.  So the port's step equals JAX's ``fast_warp=False`` step
within float regrouping, and differs from JAX's ``fast_warp=True`` step by
the packed warp's error on level 0 (README, deliberate differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_frames
from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.models.optical_flow_datmo import PipelineA as JPipelineA
from datmo_using_optical_flow_tpu_torch.benchmarks import stream_4k
from datmo_using_optical_flow_tpu_torch.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import level_sizes
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 160, 2176
_KW = dict(x_range=(0.0, H * 0.1), y_range=(0.0, W * 0.1), grid_resolution=(0.1, 0.1))
_CAP = dict(max_cells=1024, max_clusters=32, max_tracks=64)
_RAW = ("raw_velocity_x", "raw_velocity_y")


@pytest.fixture(scope="module")
def frames():
    return make_frames(3, H, W, seed=1, n_objects=8)


@pytest.fixture(scope="module")
def port_outs(frames):
    pipe = PipelineA(PipelineAConfig(capacities=CapacityConfig(**_CAP), **_KW), "cpu",
                     fast_warp=True)
    carry, outs = pipe.init_stream_carry(), []
    for f in frames:
        carry, out = pipe.step_stream(torch.as_tensor(f), carry)
        outs.append(out)
    return outs


def _jax_outs(frames, fast_warp):
    pipe = JPipelineA(JConfig(capacities=JCapacity(**_CAP), **_KW), fast_warp=fast_warp,
                      use_pallas=True)
    carry, outs = pipe.init_stream_carry(), []
    for f in frames:
        carry, out = pipe.step_stream(jnp.asarray(f), carry)
        outs.append(jax.device_get(out))
    return outs


def test_levels():
    assert [s[2:] for s in level_sizes(H, W, 0.3, 5)] == [(48, 653), (160, 2176)]
    assert [s[2:] for s in level_sizes(stream_4k.H, stream_4k.W, 0.3, 5)] == \
        [(59, 104), (196, 346), (653, 1152), (2176, 3840)]


def test_matches_jax_exact_level_0(frames, port_outs):
    """Against JAX's ``fast_warp=False`` step (level 0 exact on both sides,
    the coarse level packed on both): velocity grids atol 1e-4 m/s, cells,
    labels and the track table exact, track states atol 1e-5."""
    for got, want in zip(port_outs[1:], _jax_outs(frames, False)[1:]):
        for name in ("velocity_x", "velocity_y") + _RAW:
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                       atol=1e-4, err_msg=name)
        assert int(got.cell_count) == int(want.cell_count)
        for name in ("rows", "cols", "labels"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), name)
        for name in ("tid", "alive", "lifetime", "confirmed"):
            np.testing.assert_array_equal(getattr(got.snapshot, name).numpy(),
                                          getattr(want.snapshot, name), name)
        np.testing.assert_allclose(got.snapshot.state.numpy(), want.snapshot.state, atol=1e-5)
        assert max(np.abs(getattr(want, n)).max() for n in _RAW) > 0.05  # the scene moves


def test_matches_jax_packed_level_0(frames, port_outs):
    """Against JAX's ``fast_warp=True`` step, which packs level 0 (int16
    corner pairs) where the port warps it exactly: the raw velocity grids
    within 5e-3 m/s on 99% of the cells and within 0.2 m/s on all (measured
    at this size: p99.9 0.012, max 0.148, all on the y component)."""
    for got, want in zip(port_outs[1:], _jax_outs(frames, True)[1:]):
        for name in _RAW:
            d = np.abs(getattr(got, name).numpy() - getattr(want, name))
            assert np.percentile(d, 99) <= 5e-3 and d.max() <= 0.2, (name, d.max())


def test_benchmark_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_4k.run("cpu")
