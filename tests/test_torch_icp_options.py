"""ICP's remaining options against the JAX package's: ``coarse_stride``,
``sweep="inplace"`` and its query ``nearest_neighbors_active_inplace``, on
the cases of ``tests/test_gmfa_ops.py`` (the JAX side runs its kernel in
interpret mode).

Tolerances, those of ``tests/test_torch_icp.py``: transformation within
1e-5 (float32 sums in another order, through the Kabsch SVD), fitness rtol
1e-6, inlier RMSE rtol 1e-4, iteration counts equal.  The in-place query:
indices, winner coordinates and d2 equal; the lower bound and second-nearest
bound within the kernel's envelope of JAX's (``tests/test_torch_nn.py``) and
sound against a float64 ``cKDTree``; inactive rows exact constants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from datmo_using_optical_flow_tpu.ops import icp as jicp
from datmo_using_optical_flow_tpu.ops import nn as jnn
from datmo_using_optical_flow_tpu.ops import nn_pallas as jnp_nn
from datmo_using_optical_flow_tpu_torch.ops import icp as ticp
from datmo_using_optical_flow_tpu_torch.ops import nn as tnn
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _rigid(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:3, 3] = t
    return m


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_icp(got, want):
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-5)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse), rtol=1e-4)


@pytest.mark.parametrize("seed,yaw,t", [(0, 0.02, [0.1, -0.05, 0.02]),
                                        (1, -0.04, [-0.2, 0.1, 0.0])])
def test_coarse_stride_matches_jax(seed, yaw, t):
    """``tests/test_gmfa_ops.py::test_icp_coarse_matches_full``'s two cases."""
    rng = np.random.default_rng(seed)
    cloud = rng.uniform(-15, 15, size=(4096, 3)).astype(np.float32)
    true = _rigid(yaw, t)
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.02, size=cloud.shape)).astype(np.float32)
    m = np.ones(4096, bool)
    want = jicp.registration_icp(jnp.asarray(cloud), jnp.asarray(m), jnp.asarray(target),
                                 jnp.asarray(m), threshold=0.5, coarse_stride=4)
    got = ticp.registration_icp(*_t(cloud, m, target, m), threshold=0.5, coarse_stride=4)
    _assert_icp(got, want)
    one = ticp.registration_icp(*_t(cloud, m, target, m), threshold=0.5)
    assert int(got.iterations) != int(one.iterations)  # the coarse phase ran
    np.testing.assert_allclose(got.transformation.numpy(), one.transformation.numpy(),
                               atol=2e-4)


def _cached_case():
    """``tests/test_gmfa_ops.py::test_icp_cached_matches_uncached``'s clouds."""
    rng = np.random.default_rng(11)
    cloud = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    true = _rigid(0.01, [0.05, -0.03, 0.01])
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.01, size=cloud.shape)).astype(np.float32)
    src = np.full((4096, 3), 1e9, np.float32)
    src[:3000] = cloud
    dst = np.full((4096, 3), 1e9, np.float32)
    dst[:3000] = target
    m = np.zeros(4096, bool)
    m[:3000] = True
    return src, m, dst, m


@pytest.mark.parametrize("thr", [0.05, 0.5])
def test_inplace_sweep_matches_jax_and_the_uncached_loop(thr):
    src, sm, dst, dm = _cached_case()
    want = jicp.registration_icp(*map(jnp.asarray, (src, sm, dst, dm)), threshold=thr,
                                 cached=True, sweep="inplace")
    got = ticp.registration_icp(*_t(src, sm, dst, dm), threshold=thr, cached=True,
                                sweep="inplace")
    _assert_icp(got, want)
    # the shell skips the same rows; a row near a certificate's edge may be
    # swept on one side and certified on the other (tests/test_torch_icp.py)
    gs, ws = got.sweep_stats.numpy(), np.asarray(want.sweep_stats)
    assert gs[2] == ws[2] and gs[0] + gs[1] == ws[0] + ws[1]
    assert abs(gs[1] - ws[1]) <= 0.01 * ws[1]
    plain = ticp.registration_icp(*_t(src, sm, dst, dm), threshold=thr, cached=False)
    _assert_icp(got, plain)
    # the compact sweep: the same transform; its second-nearest bounds come
    # from other blocks, so a row may be certified on one side only
    compact = ticp.registration_icp(*_t(src, sm, dst, dm), threshold=thr, cached=True)
    assert torch.equal(got.transformation, compact.transformation)
    cs = compact.sweep_stats.numpy()
    assert gs[2] == cs[2] and gs[0] + gs[1] == cs[0] + cs[1]


def test_unknown_sweep_raises():
    src, sm, dst, dm = _cached_case()
    with pytest.raises(ValueError, match="sweep"):
        ticp.registration_icp(*_t(src, sm, dst, dm), sweep="dense")


@pytest.fixture(scope="module")
def inplace_case():
    """``tests/test_gmfa_ops.py::test_nearest_neighbors_active_inplace_matches_full``'s
    cloud: 1,024 Morton-sorted rows, the last 34 invalid (1e9)."""
    rng = np.random.default_rng(29)
    n = 1024
    src = rng.uniform(-15, 15, size=(n, 3)).astype(np.float32)
    src[990:] = 1e9
    tgt = rng.uniform(-15, 15, size=(4096, 3)).astype(np.float32)
    mask = np.ones(4096, bool)
    order = np.asarray(jnp.argsort(jnp_nn._morton_keys(jnp.asarray(src)), stable=True))
    src_s = src[order]
    valid = (np.abs(src_s) < 1e8).all(axis=1)
    d2nd, _ = cKDTree(tgt).query(src_s, k=2)
    return rng, src_s, tgt, mask, valid, (d2nd[:, 0] ** 2, d2nd[:, 1] ** 2)


@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
def test_inplace_query_matches_jax(inplace_case, frac):
    rng, src_s, tgt, mask, valid, (d1, d2nd) = inplace_case
    active = valid & (np.random.default_rng(int(frac * 10)).uniform(size=len(src_s)) < frac)
    # invalid rows inside mixed blocks: every block but the last holds some
    if 0 < frac < 1:
        assert (~active[:768]).any() and active[768:990].any() and (~active[990:]).all()
    jidx = jnp_nn.build_target_index(jnp.asarray(tgt), jnp.asarray(mask))
    want = [np.asarray(a) for a in jnn.nearest_neighbors_active_inplace(
        *map(jnp.asarray, (src_s, tgt, mask, active)), jidx)]
    tidx = tk.build_target_index(*_t(tgt, mask))
    got = [a.numpy() for a in tnn.nearest_neighbors_active_inplace(
        *_t(src_s, tgt, mask, active), tidx)]
    gi, gd, gl, gb, gc = got
    np.testing.assert_array_equal(gi, want[0])
    np.testing.assert_array_equal(gd, want[1])
    np.testing.assert_array_equal(gc, want[4])
    np.testing.assert_array_equal(gc[active], tgt[gi[active]])
    # the bounds: the kernel's envelope, 1e-5 of the recentred norms
    n = len(src_s)
    fill = tk.block_first_fill(torch.from_numpy(src_s), torch.from_numpy(active)).numpy()[:n]
    cent = np.repeat(fill[::256], 256, axis=0)[:n].astype(np.float64)
    env = 1e-5 * (((fill - cent) ** 2).sum(1) + ((gc - cent) ** 2).sum(1))
    for g, w in ((gl, want[2]), (gb, want[3])):
        assert np.all(np.abs(g[active].astype(np.float64) - w[active]) <= env[active])
    assert np.all(gl[active] <= d1[active] + 1e-5 * (1 + d1[active]))
    assert np.all(gb[active] <= d2nd[active] + 1e-5 * (1 + d2nd[active]))
    assert (gi[~active] == 0).all() and np.isinf(gd[~active]).all()
    assert np.isinf(gl[~active]).all() and (gb[~active] == 0).all() and (gc[~active] == 0).all()
    # the active rows get the full query's winners
    full = tnn.nearest_neighbors_active(*_t(src_s, tgt, mask, active), index=tidx)
    np.testing.assert_array_equal(gi[active], full[0].numpy()[active])
    np.testing.assert_array_equal(gd, full[1].numpy())


def test_icp_sound_probe_counts_no_violation_and_catches_unsound_results(monkeypatch):
    """``diagnostics/icp_sound.probe`` on a GMFA-like pair: each of 1,000
    points copied 10 times with N(0, 0.01) jitter (the densifier's), the
    second cloud moved 2 cm, 50 rows invalid.  Zero violations, while the
    float32 scan's winner is farther than the truth on many rows (why the
    probe's reference is a float64 scan) and K5's own winner is farther than
    the truth by more than 1e-6 on some rows, all within its envelope (the
    field is sparse: a block of 256 rows spans metres); with the query's
    lower bound raised by 1e-3, or its winner moved to another base point,
    it counts them."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import icp_sound

    rng = np.random.default_rng(4)
    base = rng.uniform([-25, -25, 0], [25, 25, 2], (1000, 3)).astype(np.float32)

    def dense(b):
        return (np.repeat(b, 10, axis=0) + rng.normal(0, 0.01, (10000, 3))).astype(np.float32)

    src, tgt = dense(base), dense(base + np.float32([0.02, 0.0, 0.0]))
    sm, tm = np.ones(10000, bool), np.ones(10000, bool)
    sm[-50:] = False
    report = icp_sound.probe(*_t(src, sm, tgt, tm), 0.02)
    assert icp_sound.violations(report) == 0, report
    assert report["excluded_total"] > 0 and report["scan32_winner_farther"] > 100, report
    assert icp_sound.strict_violations(report) > 0, report
    original = icp_sound.nearest_neighbors_with_bound
    for name, shift in (("lo", (0, 1e-3)), ("subcap", (10, 0.0))):
        def unsound(*args, **kw):
            idx, d2, lo = original(*args, **kw)
            return torch.remainder(idx + shift[0], len(src)), d2, lo + shift[1]

        monkeypatch.setattr(icp_sound, "nearest_neighbors_with_bound", unsound)
        bad = icp_sound.probe(*_t(src, sm, tgt, tm), 0.02)
        assert bad[f"capped_{name}_violations" if name == "lo" else "capped_subcap_mismatch"] > 0
        if name == "lo":
            assert bad["exclusion_violations"] > 0, bad
