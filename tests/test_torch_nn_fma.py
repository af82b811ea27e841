"""The port's NN distances against the JAX package's compiled functions, bit
for bit: the tiled scan's d2 and its lower bound, the block table and index
norms, and the exact d2 that the K5 queries return at their winners.

XLA's CPU code contracts ``jnp.sum(v * v, axis=1)`` into fused multiply-adds
in these functions (``fma(z, z, fma(y, y, x * x))``, ``ordered.sumsq_fma``),
except in ``nearest_neighbors_active``'s exact d2, which it rounds
sequentially; its roots are correctly rounded (``ordered.sqrt_rn``).  The
reference for each value is the jitted JAX function that computes it; the
scan's bound is taken from the jitted ``nearest_neighbors_with_bound`` on its
scan branch (the K5 limit lowered with ``monkeypatch``).  Tolerance: none,
values equal; indices equal on these clouds (no near-tie).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import nn as jnn
from datmo_using_optical_flow_tpu.ops import nn_pallas as jnp_nn
from datmo_using_optical_flow_tpu_torch.ops import nn as tnn
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SCAN_CASES = [(0, 700, 1500, 0), (1, 2000, 5000, 0), (1, 300, 2049, 100), (2, 4096, 20000, 0)]


def _cloud(seed, n, m, n_invalid=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    mask = np.ones(m, bool)
    if n_invalid:
        mask[rng.choice(m, n_invalid, replace=False)] = False
    return src, tgt, mask


def _jittered(seed=11):
    """2,048 uniform sources; 4,096 targets: each source moved by N(0, 0.05)
    and as many uniform points."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (2048, 3)).astype(np.float32)
    tgt = (np.concatenate([src, rng.uniform(-20, 20, (2048, 3))])
           + rng.normal(0, 0.05, (4096, 3))).astype(np.float32)
    return src, tgt, np.ones(4096, bool)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("seed,n,m,n_invalid", SCAN_CASES)
def test_scan_is_bit_equal(seed, n, m, n_invalid):
    src, tgt, mask = _cloud(seed, n, m, n_invalid)
    j_idx, j_d2 = map(np.asarray, jax.jit(jnn.nearest_neighbors_scan)(src, tgt, mask))
    t0 = time.perf_counter()
    idx, d2 = tnn.nearest_neighbors_scan(*_t(src, tgt, mask))
    print(f"scan {n} x {m}: {time.perf_counter() - t0:.2f} s")
    np.testing.assert_array_equal(d2.numpy(), j_d2)
    np.testing.assert_array_equal(idx.numpy(), j_idx)


@pytest.mark.parametrize("seed,n,m,n_invalid", SCAN_CASES[:3])
def test_scan_branch_and_bound_are_bit_equal(seed, n, m, n_invalid, monkeypatch):
    """Both packages' ``nearest_neighbors_with_bound`` on the scan branch:
    index, d2 and the envelope bound ``fma(2e-6, sn + max tn, 1e-6)``."""
    src, tgt, mask = _cloud(seed, n, m, n_invalid)
    monkeypatch.setattr(jnp_nn, "eligible", lambda m: False)
    want = map(np.asarray, jax.jit(jnn.nearest_neighbors_with_bound.__wrapped__)(src, tgt, mask))
    monkeypatch.setattr(tk, "MAX_TARGET", 256)
    got = tnn.nearest_neighbors_with_bound(*_t(src, tgt, mask))
    for g, w, name in zip(got, want, ("idx", "d2", "lower bound")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_query_exact_d2_is_bit_equal():
    """The full query's and the active query's d2 at the winner, K5's plain
    sweep against JAX's kernel in interpret mode; the winners agree."""
    src, tgt, mask = _jittered()
    wi, wd, _ = map(np.asarray, jnn.nearest_neighbors_with_bound(src, tgt, mask))
    gi, gd, gl = (a.numpy() for a in tnn.nearest_neighbors_with_bound(*_t(src, tgt, mask)))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert np.all(gl <= gd)
    active = np.random.default_rng(12).uniform(size=2048) < 0.3
    want = [np.asarray(a) for a in jnn.nearest_neighbors_active(src, tgt, mask, active)]
    got = [a.numpy() for a in tnn.nearest_neighbors_active(*_t(src, tgt, mask, active))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("n", [2000, 20480])
def test_index_and_block_table_are_bit_equal(n):
    """``_norm3``'s contracted, correctly rounded norms: every float of the
    target index and the block table equals the jitted JAX builders'."""
    src, tgt, mask = _cloud(3, n, 2 * n, n_invalid=n // 10)
    jidx = jax.jit(jnp_nn.build_target_index)(tgt, mask)
    tidx = tk.build_target_index(*_t(tgt, mask))
    for name, g, w in zip(tidx._fields, tidx, jidx):
        if name == "tn":
            # only a validity flag for the sweep (finite or +inf); XLA rounds
            # it sequentially in some row ranges and contracted in others
            g, w = torch.isfinite(g), np.isfinite(w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    s_sorted = src[np.asarray(jnp_nn.sort_order(src, np.ones(n, bool)))]
    jlb, jto = jax.jit(jnp_nn.build_block_table)(s_sorted, jidx)
    tlb, tto = tk.build_block_table(torch.from_numpy(s_sorted), tidx)
    np.testing.assert_array_equal(tlb.numpy(), np.asarray(jlb))
    np.testing.assert_array_equal(tto.numpy(), np.asarray(jto))
