"""The port's ICP against the JAX package's ``registration_icp`` on the cases
of ``tests/test_gmfa_ops.py`` (4096 padded points, thresholds 0.05 and 0.5).

Tolerances: transformation within 1e-5 (float32 sums over 3000 points in
another order, through the Kabsch SVD), fitness rtol 1e-6 (a ratio of
integer counts: the correspondence sets are equal), inlier RMSE rtol 1e-4,
iteration counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import icp as jicp
from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk
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


# The JAX package applies transforms inside compiled functions (GMFA's step,
# ICP's loop), where XLA fuses the dot with the translation into one loop of
# fused multiply-adds at every size.  A lone eager call of the ``dot`` takes
# another loop from 16 rows up, which rounds output columns 0 and 1 without
# fusing (jax 0.9.0, x86-64): that is XLA's code for one eager op, not the
# function the pipeline runs, so the reference here is the compiled function.
_JAX_TRANSFORM = jax.jit(jicp.transform_points)


def _transform_both(pts, t):
    got = ticp.transform_points(torch.as_tensor(pts), torch.as_tensor(t)).numpy()
    return got, np.asarray(_JAX_TRANSFORM(jnp.asarray(pts), jnp.asarray(t)))


def _double_rounded(pts, t):
    """The chain as the port computed it before: each float64 sum cast to
    float32, so rounded twice."""
    r = t[:3, :3].astype(np.float64)
    acc = (pts[:, :1].astype(np.float64) * r[:, 0]).astype(np.float32)
    for i in (1, 2):
        acc = (pts[:, i:i + 1].astype(np.float64) * r[:, i] + acc).astype(np.float32)
    return acc + t[:3, 3]


def _small_rotation(rng):
    """A rotation by up to 0.05 rad about a random axis, a shift up to 1 m."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    theta = rng.uniform(-0.05, 0.05)
    t = np.eye(4)
    t[:3, :3] += np.sin(theta) * k + (1 - np.cos(theta)) * k @ k
    t[:3, 3] = rng.uniform(-1, 1, 3)
    return t.astype(np.float32)


def _near_midpoints(rng, n):
    """Points and a transform whose sums x + r * y land within a float64
    half-ulp of a float32 midpoint, as in test_transform_points_rounds_once,
    at random mantissas, signs and scales: r = (1 - a 2^-23) 2^-24 and
    y = (1 + a 2^-23) 2^e make r * y = 2^(e-24) (1 - a^2 2^-46), just under
    half an ulp of x in [2^e, 2^(e+1)).  Output x exercises the second step
    of the chain (fma(y, r, x)), output y the third (row (1, 0, r):
    fma(z, r, fma(y, 0, x))); a third of the rows are one step of a off the
    midpoint."""
    a = int(rng.integers(1, 300))
    r = np.float32((1 - a * 2.0 ** -23) * 2.0 ** -24)
    t = np.eye(4, dtype=np.float32)
    t[0, 1] = r
    t[1] = [1, 0, r, 0]
    t[:3, 3] = rng.uniform(-1, 1, 3)
    e = rng.integers(-3, 5, n)

    def signed(v):
        return v * rng.choice([-1.0, 1.0], n)

    x = signed(rng.uniform(1, 2, n) * 2.0 ** e)
    y, z = (signed((1 + (a + rng.integers(-1, 2, n)) * 2.0 ** -23) * 2.0 ** e) for _ in range(2))
    return np.stack([x, y, z], axis=1).astype(np.float32), t


def test_transform_points_rounds_once():
    """fma(y, r1, x * r0) with x * r0 = 1 + 2^-23 and y * r1 just under half
    an ulp of it: rounding the exact sum to float64 first lands on the
    float32 midpoint, which then rounds up; the fused multiply-add does not."""
    pts = np.array([[1 + 2 ** -23, 1 + 2 ** -23, 0]], np.float32)
    t = np.eye(4, dtype=np.float32)
    t[0, 1] = np.float32(2 ** -24 * (1 - 2 ** -23))
    got, want = _transform_both(pts, t)
    assert float(want[0, 0]).hex() == "0x1.0000020000000p+0"
    assert float(_double_rounded(pts, t)[0, 0]).hex() == "0x1.0000040000000p+0"
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_points_bit_equal_small_rotations(seed):
    """Small rotations, points uniform(-20, 20)."""
    rng = np.random.default_rng(seed)
    t = _small_rotation(rng)
    got, want = _transform_both(rng.uniform(-20, 20, size=(4096, 3)).astype(np.float32), t)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_points_bit_equal_near_float32_midpoints(seed):
    pts, t = _near_midpoints(np.random.default_rng(seed), 4096)
    got, want = _transform_both(pts, t)
    assert np.array_equal(got, want)
    assert not np.array_equal(_double_rounded(pts, t), want)


@pytest.mark.parametrize("case", ["small_rotation", "near_midpoints"])
def test_transform_points_at_the_pipelines_size(case):
    """102,400 points in one call, as ICP and GMFA's step move a cloud: the
    port equals the compiled JAX function bit for bit.  Printed (``-s``): the
    coordinates that differ per output column, for this code and the
    double-rounded chain, against the compiled function and against one eager
    call of JAX's ``transform_points``."""
    rng = np.random.default_rng(7)
    n = 102400
    if case == "small_rotation":
        t = _small_rotation(rng)
        pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    else:
        pts, t = _near_midpoints(rng, n)
    got, want = _transform_both(pts, t)
    eager = np.asarray(jicp.transform_points(jnp.asarray(pts), jnp.asarray(t)))
    old = _double_rounded(pts, t)
    counts = {f"{name} vs {ref}": (a != b).sum(axis=0).tolist()
              for name, a in (("rounded once", got), ("double-rounded", old))
              for ref, b in (("compiled", want), ("eager", eager))}
    print(f"{case}, {n} points, coordinates that differ per column: {counts}")
    assert np.array_equal(got, want)
    # the eager call's difference is its columns 0 and 1 alone
    assert counts["rounded once vs eager"][2] == 0
    if case == "near_midpoints":
        assert sum(counts["double-rounded vs compiled"]) > 0


def _special_points(rng, n):
    """Points with infinities, NaNs, signed zeros, subnormals and float32's
    extremes among ordinary coordinates, and a small rotation."""
    pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    special = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -3e-39, 3.4e38, -3.4e38])
    pick = rng.random((n, 3)) < 0.3
    pts[pick] = rng.choice(special, int(pick.sum()))
    return pts, _small_rotation(rng)


_REFERENCE_CASES = [("small_rotation", s) for s in range(2)] + [
    ("near_midpoints", s) for s in range(2)] + [("special", s) for s in range(2)]


@pytest.mark.parametrize("case,seed", _REFERENCE_CASES, ids=[f"{c}-{s}" for c, s in
                                                              _REFERENCE_CASES])
def test_transform_points_reference_bit_equal_to_jitted_jax(case, seed):
    """The plain version of the card's one-launch transform
    (``round_kernels.transform_points_reference``, the body ICP's
    ``transform_points`` had) equals the compiled JAX function bit for bit (a
    NaN's payload aside), as does ``ops/icp.transform_points`` on the CPU:
    small rotations, sums near float32 midpoints, and infinities, NaNs,
    signed zeros and subnormals in the points."""
    rng = np.random.default_rng(100 + seed)
    if case == "small_rotation":
        pts, t = rng.uniform(-20, 20, size=(4096, 3)).astype(np.float32), _small_rotation(rng)
    elif case == "near_midpoints":
        pts, t = _near_midpoints(rng, 4096)
    else:
        pts, t = _special_points(rng, 4096)
    want = torch.from_numpy(np.array(_JAX_TRANSFORM(jnp.asarray(pts), jnp.asarray(t))))
    ref = rk.transform_points_reference(torch.from_numpy(pts), torch.from_numpy(t))
    assert rk.bits_equal(ref, want)
    assert rk.bits_equal(ticp.transform_points(torch.from_numpy(pts), torch.from_numpy(t)), want)
