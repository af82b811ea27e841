"""The port's GMFA step (pipeline B) against the JAX package's on the same
JAX-preprocessed clouds (as ``tests/test_gmfa_pipeline.py`` feeds them), each
step given the JAX step's threefry key (as int64 numpy words): the port draws
the new track ids from it with ``prng.randint``, which must give JAX's ids.

Tolerances: classifications agree on >= 99.9% of points (a residual within
float32 rounding of a threshold may flip); transformation within 1e-5;
moving counts, labels, alive flags and track ids exact; track states within
1e-4 absolute plus 1e-5 relative (velocities are centroid differences over
dt = 0.1 s, up to ~35 m/s here, from float32 sums taken in other orders);
the SOM within 1e-6.

ICP runs up to 30 rounds without converging on these clouds (the scene has
no static structure), and XLA and torch sum in different orders, so one
correspondence flipping at the gate moves the transform by ~1e-4.  At the
ICP threshold used here (0.2 m) both sides keep the same correspondence sets
and iteration counts on every frame; at 0.1 or 0.3 m some frame flips one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import DbscanConfig as JDbscan
from datmo_using_optical_flow_tpu.config import GMFAConfig as JConfig
from datmo_using_optical_flow_tpu.config import IcpConfig as JIcp
from datmo_using_optical_flow_tpu.io.frames import pad_points
from datmo_using_optical_flow_tpu.models import gmfa as jgmfa
from datmo_using_optical_flow_tpu.ops import nn_pallas as jnp_nn
from datmo_using_optical_flow_tpu.sim.synthetic import BoxTarget, SyntheticScene, synthetic_frame
from datmo_using_optical_flow_tpu_torch.config import (CapacityConfig, DbscanConfig, GMFAConfig,
                                                       IcpConfig)
from datmo_using_optical_flow_tpu_torch.models import gmfa as tgmfa
from datmo_using_optical_flow_tpu_torch.utils.state import carry_from_numpy, carry_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

_CAPS = dict(max_raw_points=8192, max_roi_points=512, max_cells=1024, max_clusters=8,
             max_tracks=16)
N_STEPS = 3


@pytest.fixture(scope="module")
def run():
    """Four expanded clouds and the JAX package's run over them: the seeded
    carry, then per step (key, carry before, carry after, outputs)."""
    jcfg = JConfig(dbscan=JDbscan(eps=1.0, min_samples=30), icp=JIcp(threshold=0.2),
                   capacities=JCapacity(**_CAPS))
    scene = SyntheticScene(seed=33, targets=(
        BoxTarget(center0=(5.0, -4.0, 0.75), velocity=(1.5, 0.8), points_per_frame=300),
        BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
                  points_per_frame=250)))
    pipe = jgmfa.GMFAPipeline(jcfg, max_moving_points=2048)
    clouds = []
    key = jax.random.PRNGKey(17)
    for i in range(N_STEPS + 1):
        padded, mask = pad_points(synthetic_frame(scene, i).astype(np.float32),
                                  jcfg.capacities.max_raw_points)
        key, k = jax.random.split(key)
        ex, exmask = pipe.preprocess(jnp.asarray(padded), jnp.asarray(mask), k)
        clouds.append((np.array(ex), np.array(exmask)))
    carry = pipe.seed_carry(jnp.asarray(clouds[0][0]), jnp.asarray(clouds[0][1]))
    seeded = jax.device_get(carry)
    steps = []
    key = jax.random.PRNGKey(5)
    for i in range(1, N_STEPS + 1):
        key, k = jax.random.split(key)
        before = jax.device_get(carry)
        carry, out = pipe.step(jnp.asarray(clouds[i][0]), jnp.asarray(clouds[i][1]), carry, k)
        steps.append((np.asarray(k).astype(np.int64), before, jax.device_get(carry),
                      jax.device_get(out)))
    return clouds, seeded, steps


def _port():
    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30), icp=IcpConfig(threshold=0.2),
                     capacities=CapacityConfig(**_CAPS))
    return tgmfa.GMFAPipeline(cfg, max_moving_points=2048, device="cpu")


def _compare(tout, tcarry, jout, jcarry, n_valid):
    agree = (tout.classifications.numpy()[:n_valid] == jout.classifications[:n_valid]).mean()
    assert agree >= 0.999, agree
    np.testing.assert_allclose(tout.transformation.numpy(), jout.transformation, atol=1e-5)
    assert int(tout.moving_count) == int(jout.moving_count)
    assert bool(tout.skip) == bool(jout.skip)
    np.testing.assert_array_equal(tout.labels.numpy(), jout.labels)
    assert int(tout.n_clusters) == int(jout.n_clusters)
    got = carry_to_numpy(tcarry)
    np.testing.assert_array_equal(got.table.alive, jcarry.table.alive)
    np.testing.assert_array_equal(got.table.tid, jcarry.table.tid)
    np.testing.assert_array_equal(got.table.age, jcarry.table.age)
    np.testing.assert_allclose(got.table.state, jcarry.table.state, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.som, jcarry.som, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.prev_order, jcarry.prev_order)


def test_gmfa_steps_match_jax(run):
    clouds, seeded, steps = run
    pipe = _port()
    carry = pipe.seed_carry(torch.as_tensor(clouds[0][0]), torch.as_tensor(clouds[0][1]))
    np.testing.assert_array_equal(carry.prev_order.numpy(), seeded.prev_order)
    np.testing.assert_array_equal(
        carry.prev_order.numpy(),
        np.asarray(jnp_nn.sort_order(jnp.asarray(clouds[0][0]), jnp.asarray(clouds[0][1]))))
    tracks = 0
    for i, (key, _, jcarry, jout) in enumerate(steps, start=1):
        carry, out = pipe.step(torch.as_tensor(clouds[i][0]), torch.as_tensor(clouds[i][1]),
                               carry, torch.as_tensor(key))
        _compare(out, carry, jout, jcarry, int(clouds[i][1].sum()))
        assert not bool(jout.skip) and int(jout.n_clusters) >= 1
        tracks += int(jcarry.table.alive.sum())
    assert tracks >= 2  # tracks were born and carried


def test_jax_carry_continues_in_the_port(run):
    """A JAX carry moved across by carry_from_numpy gives the same next step."""
    clouds, _, steps = run
    key, before, jcarry, jout = steps[-1]
    tcarry = carry_from_numpy(before, "cpu")
    assert isinstance(tcarry, tgmfa.GmfaCarry) and isinstance(tcarry.table, tgmfa.TrackTableB)
    carry, out = _port().step(torch.as_tensor(clouds[N_STEPS][0]),
                              torch.as_tensor(clouds[N_STEPS][1]), tcarry, torch.as_tensor(key))
    _compare(out, carry, jout, jcarry, int(clouds[N_STEPS][1].sum()))


def test_skip_frame_keeps_the_carry(run):
    """A frame with no moving ROI points leaves the whole carry untouched."""
    clouds, _, steps = run
    pipe = _port()
    carry = carry_from_numpy(steps[-1][2], "cpu")
    pts = torch.as_tensor(clouds[N_STEPS][0])
    mask = torch.as_tensor(clouds[N_STEPS][1])
    carry = carry._replace(prev_points=pts, prev_mask=mask)
    new, out = pipe.step(pts, mask, carry, torch.as_tensor(steps[-1][0]))  # nothing moves
    assert bool(out.skip) and int(out.moving_count) == 0
    for a, b in zip(carry_to_numpy(new)[:2] + (carry_to_numpy(new).som,),
                    carry_to_numpy(carry)[:2] + (carry_to_numpy(carry).som,)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(new.table.tid.numpy(), carry.table.tid.numpy())
