"""The port's ICP against the JAX package's ``registration_icp`` on the cases
of ``tests/test_gmfa_ops.py`` (4096 padded points, thresholds 0.05 and 0.5).

Tolerances: transformation within 1e-5 (float32 sums over 3000 points in
another order, through the Kabsch SVD), fitness rtol 1e-6 (a ratio of
integer counts: the correspondence sets are equal), inlier RMSE rtol 1e-4,
iteration counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import icp as jicp
from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _rigid(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:3, 3] = t
    return m


def _case(seed=11, pad_value=1e9):
    rng = np.random.default_rng(seed)
    cloud = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    true = _rigid(0.01, [0.05, -0.03, 0.01])
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.01, size=cloud.shape)).astype(np.float32)
    pad = 4096
    src = np.full((pad, 3), pad_value, np.float32)
    src[:3000] = cloud
    dst = np.full((pad, 3), pad_value, np.float32)
    dst[:3000] = target
    m = np.zeros(pad, bool)
    m[:3000] = True
    return src, dst, m


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("thr", [0.05, 0.5])
def test_registration_icp_matches_jax(thr, cached):
    src, dst, m = _case()
    want = jicp.registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                                 jnp.asarray(m), threshold=thr, cached=cached)
    got = ticp.registration_icp(torch.as_tensor(src), torch.as_tensor(m),
                                torch.as_tensor(dst), torch.as_tensor(m), threshold=thr,
                                cached=cached)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-5)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse), rtol=1e-4)
    if cached:
        # the exclusion shell skips the same rows; a row near a certificate's
        # edge may be swept on one side and certified on the other (the
        # second-nearest bounds differ within the kernel's envelope)
        gs, ws = got.sweep_stats.numpy(), np.asarray(want.sweep_stats)
        assert gs[2] == ws[2] and gs[0] + gs[1] == ws[0] + ws[1]
        assert abs(gs[1] - ws[1]) <= 0.01 * ws[1]


def test_registration_icp_early_exit_and_midcloud_padding():
    """Padding at the origin (inside the cloud's box) and a threshold at which
    Open3D's criteria fire before max_iterations."""
    src, dst, m = _case(seed=17, pad_value=0.0)
    for cached in (False, True):
        want = jicp.registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                                     jnp.asarray(m), threshold=0.3, cached=cached)
        got = ticp.registration_icp(torch.as_tensor(src), torch.as_tensor(m),
                                    torch.as_tensor(dst), torch.as_tensor(m), threshold=0.3,
                                    cached=cached)
        assert int(got.iterations) == int(want.iterations) < 30
        np.testing.assert_allclose(got.transformation.numpy(),
                                   np.asarray(want.transformation), atol=1e-5)
        np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)


def test_transform_points():
    t = _rigid(0.3, [1, 2, 3]).astype(np.float32)
    pts = np.random.default_rng(3).normal(size=(10, 3)).astype(np.float32)
    got = ticp.transform_points(torch.as_tensor(pts), torch.as_tensor(t)).numpy()
    want = np.asarray(jicp.transform_points(jnp.asarray(pts), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
