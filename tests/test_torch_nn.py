"""The port's K5 helpers, its plain sweep and the NN queries against the JAX
package (``ops/nn_pallas.py`` in interpret mode, ``ops/nn.py``) on the same
numpy inputs.

Tolerances: integer outputs exact; index-helper floats within 1e-6.  The
sweep's raw d2, lower bound and second-nearest bound agree within 1e-5
relative to the recentred norms ``|s - c|^2 + |w - c|^2`` (c the block's row
0, w the winner): that is the kernel's stated error envelope (ALPHA), and the
two sides reduce the 3-term dot in different orders (measured: ~2e-7 of it,
against float64).  The queries' d2 is recomputed at the winner by direct
subtraction and agrees within rtol 1e-5.  ``idx`` is equal except at near-ties: a row may
differ only where the two winners' float64 distances are within 1e-5
relative of each other.  Both bounds are also checked sound against a float64
``cKDTree``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from datmo_using_optical_flow_tpu.ops import nn as jnn
from datmo_using_optical_flow_tpu.ops import nn_pallas as jnp_nn
from datmo_using_optical_flow_tpu_torch.ops import nn as tnn
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

RTOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cloud(seed, n, m, n_invalid=0, spread=10.0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(-spread, spread, size=(m, 3)).astype(np.float32)
    mask = np.ones(m, bool)
    if n_invalid:
        bad = rng.choice(m, n_invalid, replace=False)
        mask[bad] = False
        tgt[bad] = 1e9
    return src, tgt, mask


def _assert_idx_near_ties(got, want, src, tgt):
    diff = np.nonzero(got != want)[0]
    d_got = ((src[diff].astype(np.float64) - tgt[got[diff]]) ** 2).sum(1)
    d_want = ((src[diff].astype(np.float64) - tgt[want[diff]]) ** 2).sum(1)
    assert np.all(np.abs(d_got - d_want) <= 1e-5 * (1.0 + d_want)), (diff, d_got, d_want)
    assert len(diff) <= max(2, len(got) // 500), len(diff)


def _envelope(src_s, crd):
    """1e-5 x (|s - c|^2 + |w - c|^2) per row, c = the row's block row 0."""
    n = len(src_s)
    c = np.repeat(np.pad(src_s, ((0, (-n) % 256), (0, 0)), mode="edge")[::256], 256, axis=0)[:n]
    s64, w64, c64 = (a.astype(np.float64) for a in (src_s, crd, c))
    return 1e-5 * (((s64 - c64) ** 2).sum(1) + ((w64 - c64) ** 2).sum(1))


def _query_envelope(src, order, crd):
    """:func:`_envelope` of a query whose sweep saw ``src[order]``."""
    env = np.empty(len(src))
    env[order] = _envelope(src[order], crd[order])
    return env


def _sound(bound, truth):
    return np.all(bound <= truth + 1e-5 * (1.0 + truth))


@pytest.mark.parametrize("n_invalid", [0, 300])
def test_index_helpers_match_jax(n_invalid):
    src, tgt, mask = _cloud(0, 1500, 3000, n_invalid)
    np.testing.assert_array_equal(_np(tk._morton_keys(torch.as_tensor(tgt))),
                                  np.asarray(jnp_nn._morton_keys(jnp.asarray(tgt))))
    want_order = np.asarray(jnp_nn.sort_order(jnp.asarray(tgt), jnp.asarray(mask)))
    got_order = tk.sort_order(torch.as_tensor(tgt), torch.as_tensor(mask))
    np.testing.assert_array_equal(_np(got_order), want_order)

    jidx = jnp_nn.build_target_index(jnp.asarray(tgt), jnp.asarray(mask))
    tidx = tk.build_target_index(torch.as_tensor(tgt), torch.as_tensor(mask))
    for name, g, w in zip(tidx._fields, tidx, jidx):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)

    keep = np.random.default_rng(1).uniform(size=1500) < 0.6
    keep[256:512] = False  # a whole block with no kept row
    np.testing.assert_array_equal(
        _np(tk.block_first_fill(torch.as_tensor(src), torch.as_tensor(keep))),
        np.asarray(jnp_nn.block_first_fill(jnp.asarray(src), jnp.asarray(keep))))

    s_sorted = src[np.asarray(jnp.argsort(jnp_nn._morton_keys(jnp.asarray(src)), stable=True))]
    jlb, jto = jnp_nn.build_block_table(jnp.asarray(s_sorted), jidx)
    tlb, tto = tk.build_block_table(torch.as_tensor(s_sorted), tidx)
    np.testing.assert_allclose(_np(tlb), np.asarray(jlb), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(tto), np.asarray(jto))


def _sweep_cases():
    # (cap, block_counts kind); kinds: None, "zeros" (some blocks inactive)
    return [(None, None), (2.0, None), (None, "zeros"), (0.5, "zeros")]


@pytest.mark.parametrize("cap,counts", _sweep_cases())
def test_plain_sweep_matches_pallas(cap, counts):
    src, tgt, mask = _cloud(2, 2000, 4000, n_invalid=96)
    order = np.asarray(jnp.argsort(jnp_nn._morton_keys(jnp.asarray(src)), stable=True))
    src_s = src[order]
    jidx = jnp_nn.build_target_index(jnp.asarray(tgt), jnp.asarray(mask))
    tidx = tk.build_target_index(torch.as_tensor(tgt), torch.as_tensor(mask))
    kw_j, kw_t = {}, {}
    if cap is not None:
        cap2 = np.float32(cap * cap)
        kw_j["cap2"], kw_t["cap2"] = jnp.float32(cap2), float(cap2)
    if counts == "zeros":
        bc = np.full(8, 256, np.int32)
        bc[[1, 4, 5]] = 0
        bc[7] = 2000 - 7 * 256
        kw_j["block_counts"], kw_t["block_counts"] = jnp.asarray(bc), torch.as_tensor(bc)
    want = [np.asarray(x) for x in jnp_nn.nearest_neighbors_pallas(jnp.asarray(src_s), jidx,
                                                                   **kw_j)]
    got = [_np(x) for x in tk.nearest_neighbors_reference(torch.as_tensor(src_s), tidx, **kw_t)]
    # the wrapper on a CPU tensor is the plain version
    for g, g2 in zip(got, tk.nearest_neighbors(torch.as_tensor(src_s), tidx, **kw_t)):
        np.testing.assert_array_equal(g, _np(g2))
    assert tk.LAUNCHES["nearest_neighbors"] == 0
    gi, gd, gl, gb, gc = got
    wi, wd, wl, wb, wc = want
    _assert_idx_near_ties(gi, wi, src_s, tgt)
    same = (gi == wi) & np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    np.testing.assert_array_equal(gc[same], wc[same])
    env = _envelope(src_s, wc)[same]
    for g, w in ((gd, wd), (gl, wl), (gb, wb)):
        assert np.all(np.abs(g[same].astype(np.float64) - w[same]) <= env)
        np.testing.assert_array_equal(g[~np.isfinite(wd)], w[~np.isfinite(wd)])

    valid = tgt[mask].astype(np.float64)
    orig = np.nonzero(mask)[0]
    dist, kidx = cKDTree(valid).query(src_s.astype(np.float64), k=2)
    d1, d2nd = dist[:, 0] ** 2, dist[:, 1] ** 2
    live = np.ones(len(src_s), bool)
    if counts == "zeros":
        live = np.repeat(bc > 0, 256)[:len(src_s)]
        assert (gi[~live] == 0).all() and np.isinf(gd[~live]).all()
        assert np.isinf(gl[~live]).all() and np.isinf(gb[~live]).all()
        assert (gc[~live] == 0).all()
    assert _sound(gl[live], d1[live]) and _sound(gb[live], d2nd[live])
    exact = live & (d1 < (np.inf if cap is None else cap * cap * (1 - 1e-4)))
    _assert_idx_near_ties(gi[exact], orig[kidx[exact, 0]], src_s[exact], tgt)


def test_with_bound_and_active_match_jax():
    src, tgt, mask = _cloud(4, 1800, 4096, n_invalid=200, spread=5.0)
    jargs = (jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    targs = (torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(mask))
    t_order = np.array(jnp_nn.sort_order(jnp.asarray(tgt), jnp.asarray(mask)))
    s_order = np.array(jnp_nn.sort_order(jnp.asarray(src), jnp.ones(1800, bool)))
    cap2 = np.float32(0.3 ** 2)
    for kw in ({}, {"cap2": cap2, "order": True}):
        jkw, tkw = {}, {}
        if kw:
            jkw = dict(cap2=jnp.float32(cap2), tgt_order=jnp.asarray(t_order),
                       src_order=jnp.asarray(s_order))
            tkw = dict(cap2=float(cap2), tgt_order=torch.as_tensor(t_order),
                       src_order=torch.as_tensor(s_order))
        wi, wd, wl = map(np.asarray, jnn.nearest_neighbors_with_bound(*jargs, **jkw))
        gi, gd, gl = map(_np, tnn.nearest_neighbors_with_bound(*targs, **tkw))
        _assert_idx_near_ties(gi, wi, src, tgt)
        same = gi == wi
        np.testing.assert_array_equal(gd[same], wd[same])
        order = s_order if kw else np.argsort(_np(tk._morton_keys(torch.as_tensor(src))),
                                              kind="stable")
        env = _query_envelope(src, order, tgt[wi])
        assert np.all(np.abs(gl.astype(np.float64) - wl) <= env)
    ti, td = map(_np, tnn.nearest_neighbors(*targs))
    full_i, full_d = ti, td

    active = np.random.default_rng(5).uniform(size=1800) < 0.15
    want = [np.asarray(x) for x in jnn.nearest_neighbors_active(
        *jargs, jnp.asarray(active), cap2=jnp.float32(cap2))]
    got = [_np(x) for x in tnn.nearest_neighbors_active(*targs, torch.as_tensor(active),
                                                        cap2=float(cap2))]
    _assert_idx_near_ties(got[0], want[0], src, tgt)
    same = got[0] == want[0]
    np.testing.assert_array_equal(got[1][same], want[1][same])
    part = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
    env = _query_envelope(src, part, want[4])
    for g, w in zip(got[2:4], want[2:4]):
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        assert np.all(np.abs(g[fin].astype(np.float64) - w[fin]) <= env[fin])
    # the active query equals the full query on active rows (uncapped): the
    # same winners; its d2 is the exact d2 at the winner as JAX's active
    # query rounds it, (x*x + y*y) + z*z, where the full query contracts
    ai, ad, al, ab, ac = map(_np, tnn.nearest_neighbors_active(*targs, torch.as_tensor(active)))
    np.testing.assert_array_equal(ai[active], full_i[active])
    np.testing.assert_array_equal(ac[active], tgt[ai[active]])
    jad = np.asarray(jnn.nearest_neighbors_active(*jargs, jnp.asarray(active))[1])
    np.testing.assert_array_equal(ad[active & (ai == full_i)], jad[active & (ai == full_i)])
    dif = src[active] - ac[active]
    np.testing.assert_array_equal(
        ad[active], (dif[:, 0] * dif[:, 0] + dif[:, 1] * dif[:, 1]) + dif[:, 2] * dif[:, 2])
    np.testing.assert_allclose(ad[active], full_d[active], rtol=2.4e-7)
    assert (ai[~active] == 0).all() and np.isinf(ad[~active]).all()
    assert np.isinf(al[~active]).all() and (ab[~active] == 0).all() and (ac[~active] == 0).all()


def _bmax_after(p, k):
    """Each block's bmax after its first ``k`` tiles: the serial sweep on the
    table cut after ``k`` tiles gives each row's best then."""
    lb2 = p.lb2.clone()
    lb2[:, k:] = torch.inf
    d2 = tk._sweep_reference(p._replace(lb2=lb2))[0][1]
    return torch.minimum(d2.reshape(-1, tk.SRC_BLOCK).amax(1), p.cap2[0])


def _chunk_case(kind):
    """Prepared sweep inputs for the replay test: ``long``, an active subset
    partitioned to the front whose last live block mixes active rows with
    inactive ones from across the cloud (its bounds are 0 for every tile, so
    it walks them all); ``mid``, a Morton-sorted cloud whose blocks stop at
    their 4th tile, on a bmax that fell at their 3rd (the 4th bound is set
    between bmax after the 2nd and after the 3rd tile, so every chunk size
    must replay that drop to stop there); ``capped``, the active subset with
    an ICP-style cap."""
    rng = np.random.default_rng(7)
    tgt = rng.uniform(-8, 8, size=(6000, 3)).astype(np.float32)
    mask = np.ones(6000, bool)
    mask[rng.choice(6000, 150, replace=False)] = False
    src = (tgt[:2000] + rng.normal(0, 0.05, size=(2000, 3))).astype(np.float32)
    index = tk.build_target_index(torch.as_tensor(tgt), torch.as_tensor(mask))
    src_s = torch.as_tensor(src)[tk.sort_order(torch.as_tensor(src), torch.ones(2000, dtype=bool))
                                 .long()]
    if kind == "mid":
        p = tk.prepare(src_s, index)
        b2, b3 = _bmax_after(p, 2), _bmax_after(p, 3)
        lb2 = p.lb2.clone()
        lb2[:, 3] = torch.where(b3 < b2, (b2 + b3) * 0.5, lb2[:, 3])
        return p._replace(lb2=lb2)
    active = torch.as_tensor(rng.uniform(size=2000) < 0.15)
    src_c, _, n_active = tnn.partition_active(src_s, active)
    cap2 = float(np.float32(0.3) * np.float32(0.3)) if kind == "capped" else None
    return tk.prepare(src_c, index, n_active, cap2)


@pytest.mark.parametrize("kind", ["long", "mid", "capped"])
@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_chunked_replay_equals_the_serial_sweep(kind, chunk):
    """The kernel's cluster scheme (``chunk`` tiles scanned at once, then
    replayed in order) gives the serial sweep's outputs and visits, bit for
    bit."""
    p = _chunk_case(kind)
    m_tiles = p.index.packed.shape[0]
    want, want_visits = tk._sweep_reference(p)
    got, got_visits = tk._sweep_reference(p, chunk=chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got_visits, want_visits)
    live = want_visits[p.block_counts > 0]
    if kind == "long":
        # the mixed block walks every tile that holds a valid target
        assert int(live.max()) == int(torch.isfinite(p.lb2[0]).sum()) > m_tiles // 2
    if kind == "mid":  # stops inside a chunk, on a bmax that fell within it
        assert bool((live == 3).any()), live
    if kind == "capped":
        assert bool((live < m_tiles).all()), live


def test_oversized_target_raises():
    """Targets above K5's 2^18 (which raised before the scan was ported)
    take the tiled scan: the same result as ``nearest_neighbors_scan``."""
    rng = np.random.default_rng(9)
    tgt = torch.from_numpy(rng.uniform(-50, 50, ((1 << 18) + 1, 3)).astype(np.float32))
    rows = [5, 100000, 1 << 18, 7]
    src = tgt[rows] + 1e-3
    mask = torch.ones(tgt.shape[0], dtype=torch.bool)
    idx, d2 = tnn.nearest_neighbors(src, tgt, mask)
    s_idx, s_d2 = tnn.nearest_neighbors_scan(src, tgt, mask)
    assert idx.tolist() == rows == s_idx.tolist()
    assert torch.equal(d2, s_d2)
