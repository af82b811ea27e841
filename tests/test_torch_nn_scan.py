"""The NN scan fallback for targets above K5's limit and ``align_by_nearest``
(``ops/nn``) against the JAX package's, on the same numpy inputs.

The scan computes d2 by the expansion ``|s|^2 + |t|^2 - 2 s.t``, with one
float32 matrix product per 512-target tile and the norms in XLA's contracted
form (``ops/nn.sumsq_fma``): d2 and the indices equal JAX's bit for bit.
The envelope's lower bound (``_scan_lower_bound``: 2e-6 (|s|^2 + max |t|^2)
+ 1e-6) is checked sound against a float64 ``cKDTree``.  The routing above ``MAX_TARGET`` runs
at a small size, the limit lowered with ``monkeypatch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from datmo_using_optical_flow_tpu.ops import nn as jnn
from datmo_using_optical_flow_tpu_torch.ops import nn as tnn
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _cloud(seed, n, m, spread=20.0, n_invalid=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-spread, spread, (m, 3)).astype(np.float32)
    mask = np.ones(m, bool)
    if n_invalid:
        bad = rng.choice(m, n_invalid, replace=False)
        mask[bad] = False
    return src, tgt, mask


def _envelope(src, tgt, mask):
    sn = (src.astype(np.float64) ** 2).sum(1)
    return 2e-6 * (sn + (tgt[mask].astype(np.float64) ** 2).sum(1).max()) + 1e-6


def _two_best(src, tgt, mask):
    """float64 distances to the nearest and second-nearest valid targets."""
    d, _ = cKDTree(tgt[mask].astype(np.float64)).query(src.astype(np.float64), k=2)
    return d[:, 0] ** 2, d[:, 1] ** 2


@pytest.mark.parametrize("seed,n,m,n_invalid", [(0, 700, 1500, 0), (1, 300, 2049, 100),
                                                 (2, 513, 512, 37)])
def test_scan_matches_jax(seed, n, m, n_invalid):
    src, tgt, mask = _cloud(seed, n, m, n_invalid=n_invalid)
    j_idx, j_d2 = (np.asarray(a) for a in jnn.nearest_neighbors_scan(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask)))
    idx, d2 = tnn.nearest_neighbors_scan(torch.from_numpy(src), torch.from_numpy(tgt),
                                         torch.from_numpy(mask))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(d2.numpy(), j_d2)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert mask[idx.numpy()].all()


def test_scan_lower_bound_is_sound():
    src, tgt, mask = _cloud(3, 1000, 3000, spread=40.0, n_invalid=50)
    s, t, m = (torch.from_numpy(a) for a in (src, tgt, mask))
    _, d2 = tnn.nearest_neighbors_scan(s, t, m)
    lo = tnn._scan_lower_bound(s, t, m, d2).numpy()
    want_lo = np.asarray(jnn._scan_lower_bound(jnp.asarray(src), jnp.asarray(tgt),
                                               jnp.asarray(mask), jnp.asarray(d2.numpy())))
    np.testing.assert_allclose(lo, want_lo, rtol=1e-6, atol=1e-6)
    true_d2, _ = _two_best(src, tgt, mask)
    assert np.all(lo <= true_d2)
    assert np.all(lo <= d2.numpy())


def test_scan_with_no_valid_target():
    src, tgt, _ = _cloud(4, 20, 600)
    idx, d2 = tnn.nearest_neighbors_scan(torch.from_numpy(src), torch.from_numpy(tgt),
                                         torch.zeros(600, dtype=torch.bool))
    assert (idx == 0).all() and torch.isinf(d2).all()


def test_queries_route_to_the_scan_above_max_target(monkeypatch):
    src, tgt, mask = _cloud(5, 400, 1200, n_invalid=30)
    s, t, m = (torch.from_numpy(a) for a in (src, tgt, mask))
    below = tnn.nearest_neighbors_with_bound(s, t, m)  # K5's plain sweep
    monkeypatch.setattr(tk, "MAX_TARGET", 1024)
    assert not tk.eligible(1200) and tk.eligible(1024)
    idx, d2, lo = tnn.nearest_neighbors_with_bound(s, t, m, cap2=0.01)  # cap2 not used
    s_idx, s_d2 = tnn.nearest_neighbors_scan(s, t, m)
    assert torch.equal(idx, s_idx) and torch.equal(d2, s_d2)
    assert torch.equal(lo, tnn._scan_lower_bound(s, t, m, s_d2))
    env = _envelope(src, tgt, mask)
    assert np.all(np.abs(d2.numpy() - below[1].numpy()) <= env)

    active = torch.from_numpy(np.random.default_rng(6).random(400) < 0.3)
    a_idx, a_d2, a_lo, a_b2, a_crd = tnn.nearest_neighbors_active(s, t, m, active)
    assert torch.equal(a_idx, torch.where(active, idx, 0))
    assert torch.equal(a_d2, torch.where(active, d2, torch.inf))
    assert torch.equal(a_lo, torch.where(active, lo, torch.inf))
    assert not a_b2.any()
    assert torch.equal(a_crd, torch.where(active[:, None], t[idx.long()], 0.0))


@pytest.mark.parametrize("seed,n,m", [(7, 600, 900), (8, 300, 2100)])
def test_align_by_nearest_matches_jax(seed, n, m):
    src, tgt, mask = _cloud(seed, n, m, spread=5.0, n_invalid=40)
    want = np.asarray(jnn.align_by_nearest(jnp.asarray(src), jnp.asarray(tgt),
                                           jnp.asarray(mask)))
    got = tnn.align_by_nearest(torch.from_numpy(src), torch.from_numpy(tgt),
                               torch.from_numpy(mask)).numpy()
    differ = np.nonzero((got != want).any(1))[0]
    # a row may differ only at a near-tie: both winners equally near in float64
    d_got = ((src[differ].astype(np.float64) - got[differ]) ** 2).sum(1)
    d_want = ((src[differ].astype(np.float64) - want[differ]) ** 2).sum(1)
    assert np.all(np.abs(d_got - d_want) <= 1e-5 * (1.0 + d_want))
    assert len(differ) <= 2
    assert np.isin(got.view([("", got.dtype)] * 3), tgt[mask].view([("", tgt.dtype)] * 3)).all()
