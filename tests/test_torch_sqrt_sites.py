"""The port's square roots and their sums against the JAX package's compiled
functions, bit for bit.

XLA's CPU square root is correctly rounded, torch's float32 one on the CPU is
not (it is an ulp off for ~20% of uniform(0, 1) inputs); the port takes
``ordered.sqrt_rn`` (the float64 root rounded) at every site, and the sum
under it in the form XLA compiles there: contracted (``ordered.sumsq_fma``,
``fma32``) or not.  Where the site's value leaves the JAX function (pipeline
A's magnitude, GMFA's residuals) the reference is that function, jitted;
where it stays inside (tracker A's eigenvalue discriminant and association
distance, GMFA's Hungarian cost, ICP's shell and certificate), the reference
is the JAX source line jitted alone, since the values around it (segment
sums, Kabsch's SVD) already differ in the last bits between the packages.
Tolerance: none, values equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.config import CapacityConfig as JCapacity
from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.models import optical_flow_datmo as jpipe
from datmo_using_optical_flow_tpu_torch.models import gmfa as tgmfa
from datmo_using_optical_flow_tpu_torch.models import optical_flow_datmo as tpipe
from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from datmo_using_optical_flow_tpu_torch.utils.ordered import fma32, sqrt_rn, sumsq_fma
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def magnitude_case(h, w):
    """JAX's compiled frame-pair step on two ``make_frames`` frames and the
    port's magnitude of its filtered velocities."""
    cfg = JConfig(x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1),
                  capacities=JCapacity(max_cells=4096, max_clusters=32, max_tracks=64))
    frames = make_frames(2, h, w, seed=0)
    pipe = jpipe.PipelineA(cfg)
    _, out = pipe.step(jnp.asarray(frames[0]), jnp.asarray(frames[1]), pipe.init_carry())
    vx, vy = _t(np.asarray(out.velocity_x), np.asarray(out.velocity_y))
    return tpipe.velocity_magnitude(vx, vy).numpy(), np.asarray(out.magnitude)


def test_magnitude_in_the_compiled_step():
    got, want = magnitude_case(256, 320)
    assert (want > 0).sum() > 10000
    np.testing.assert_array_equal(got, want)


def _residual_case(n, seed):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    prev_t = (points + rng.normal(0, 0.1, (n, 3))).astype(np.float32)
    idx = rng.integers(0, n, n).astype(np.int32)
    d2s = np.where(rng.uniform(size=n) < 0.9, 1.0, np.inf).astype(np.float32)
    mask = rng.uniform(size=n) < 0.97
    return points, prev_t, idx, d2s, mask


@jax.jit
def _jax_residuals(points, prev_t, idx, d2s, same_size, mask):
    """JAX ``models/gmfa.py:551-557`` (the cap is 2 x 0.6)."""
    aligned = prev_t[idx]
    ref_pts = jnp.where(same_size, prev_t, aligned)
    residuals = jnp.linalg.norm(points - ref_pts, axis=1)
    residuals = jnp.where(same_size | jnp.isfinite(d2s), residuals, jnp.float32(1.2))
    return jnp.where(mask, residuals, 0.0)


def _port_residuals(points, prev_t, idx, d2s, same_size, mask):
    points, prev_t, idx, d2s, mask = _t(points, prev_t, idx, d2s, mask)
    same = torch.tensor(same_size)
    ref_pts = torch.where(same, prev_t, prev_t[idx.long()])
    res = tgmfa._residual_norm(points - ref_pts, same)
    res = torch.where(same | torch.isfinite(d2s), res, 1.2)
    return torch.where(mask, res, 0.0).numpy()


@pytest.mark.parametrize("n,same_size", [(102400, False), (16384, True), (16384, False),
                                         (1000, True)])
def test_gmfa_residuals(n, same_size):
    """Both branches of the residual: NN-aligned at GMFA's reference load,
    index-wise up to 16,384 rows (above that XLA contracts some row ranges
    of this branch and not others)."""
    args = _residual_case(n, 5) + ()
    args = args[:3] + (args[3], same_size, args[4])
    want = np.asarray(_jax_residuals(*args))
    np.testing.assert_array_equal(_port_residuals(*args), want)


def test_gmfa_residuals_index_wise_at_reference_load():
    """The index-wise branch at 102,400 rows: every row is one of the two
    forms XLA compiles (printed with ``-s``: how many rows take which)."""
    args = _residual_case(102400, 6)
    args = args[:4] + (True, args[4])
    want = np.asarray(_jax_residuals(*args))
    got = _port_residuals(*args)
    points, prev_t, mask = args[0], args[1], args[5]
    diff = torch.from_numpy(points - prev_t)
    fused = np.where(mask, sqrt_rn(sumsq_fma(diff)).numpy(), 0.0)
    print(f"index-wise, 102,400 rows: {(got != want).sum()} rows differ from the "
          f"sequential sum, {(fused != want).sum()} from the contracted one")
    assert np.all((got == want) | (fused == want))


def test_tracker_a_sites():
    """``tracker_a.py:108`` (the eigenvalue discriminant, contracted as
    fma(b, b, hd * hd)) and ``:169`` (the association distance over 4
    features, contracted in order, inside ``lax.scan``)."""
    rng = np.random.default_rng(0)
    a, b, d = (rng.uniform(0, 3, 5000).astype(np.float32) for _ in range(3))
    want = jax.jit(lambda a, b, d: jnp.sqrt(jnp.maximum(((a - d) * 0.5) ** 2 + b * b, 0.0)))(
        a, b, d)
    ta, tb, td = _t(a, b, d)
    hd = (ta - td) * 0.5
    got = sqrt_rn(torch.clamp(fma32(tb, tb, hd * hd), min=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    feats = rng.uniform(0, 40, (32, 4)).astype(np.float32)
    track = rng.uniform(0, 40, (64, 4)).astype(np.float32)
    track[:, 2:] = 0

    def dists(feats, track):
        def body(c, f):
            return c, jnp.linalg.norm(f[None, :] - track, axis=1)
        return jax.lax.scan(body, 0, feats)[1]

    want = np.asarray(jax.jit(dists)(feats, track))
    tf, tt = _t(feats, track)
    got = torch.stack([sqrt_rn(sumsq_fma(tf[j][None, :] - tt)) for j in range(32)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_gmfa_hungarian_cost():
    """``models/gmfa.py:586-587``: the (tracks, clusters) feature distance."""
    rng = np.random.default_rng(1)
    tf = rng.uniform(0, 40, (16, 4)).astype(np.float32)
    fe = rng.uniform(0, 40, (8, 4)).astype(np.float32)
    want = jax.jit(lambda tf, fe: jnp.sqrt(jnp.maximum(
        jnp.sum((tf[:, None] - fe[None]) * (tf[:, None] - fe[None]), axis=-1), 0.0)))(tf, fe)
    a, b = _t(tf, fe)
    got = sqrt_rn(torch.clamp(sumsq_fma(a[:, None, :] - b[None, :, :]), min=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_icp_shell_and_certificate():
    """``ops/icp.py:109`` (eval_full's d2) and ``:118-134`` (eval_cached's
    shell and certificate) on a moved cloud, against the JAX lines jitted
    together.  (The RMSE's root, ``:155``, takes a sum that the port runs in
    another order.)"""
    rng = np.random.default_rng(2)
    n = 20000
    srcf = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tr = np.eye(4, dtype=np.float32)
    tr[:2, :2] = [[np.cos(0.01), -np.sin(0.01)], [np.sin(0.01), np.cos(0.01)]]
    tr[:3, 3] = [0.05, -0.02, 0.01]
    qpos = (srcf + rng.normal(0, 0.01, srcf.shape)).astype(np.float32)
    qw = (srcf + rng.normal(0, 0.05, srcf.shape)).astype(np.float32)
    lo_old, b2_old = (rng.uniform(0, 0.01, n).astype(np.float32) for _ in range(2))

    @jax.jit
    def jax_lines(srcf, transform, lo_old, qw, qpos, b2_old):
        pts = srcf @ transform[:3, :3].T + transform[:3, 3]
        delta = jnp.linalg.norm(pts - qpos, axis=1) + 1e-4
        lo_new = jnp.sqrt(lo_old) - delta
        dw2 = jnp.sum((pts - qw) ** 2, axis=1)
        b2_dec = jnp.sqrt(b2_old) - delta
        diff = pts - qw
        d2 = jnp.sum(diff * diff, axis=1)
        return delta, lo_new, dw2, b2_dec, jnp.sqrt(dw2), d2

    want = [np.asarray(x) for x in jax_lines(srcf, tr, lo_old, qw, qpos, b2_old)]
    s, t, lo, w, q, b2 = _t(srcf, tr, lo_old, qw, qpos, b2_old)
    pts = ticp.transform_points(s, t)
    delta = sqrt_rn(sumsq_fma(pts - q)) + ticp._DELTA_PAD
    dw2 = sumsq_fma(pts - w)
    got = [delta, sqrt_rn(lo) - delta, dw2, sqrt_rn(b2) - delta, sqrt_rn(dw2), dw2]
    for name, g, wnt in zip(("delta", "lo_new", "dw2", "b2_dec", "sqrt dw2", "d2"), got, want):
        np.testing.assert_array_equal(g.numpy(), wnt, err_msg=name)
