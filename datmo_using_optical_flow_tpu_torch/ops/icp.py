"""Point-to-point ICP (ego-motion), the counterpart of
``datmo_using_optical_flow_tpu.ops.icp``.

Open3D's ``registration_icp(source, target, threshold, I,
TransformationEstimationPointToPoint())`` as called at ``GMFA/GMFA.py:297-309``:
1-NN correspondences gated by ``threshold`` (K5 sweeps), a weighted Kabsch
estimate per iteration, and Open3D's stopping rules (both relative changes of
fitness and inlier RMSE below their thresholds, or ``max_iterations``).

The JAX package's ``lax.while_loop`` becomes ``max_iterations`` rounds of a
Python loop that freezes the state once the stopping rules fire: the device
never waits for the host to read fitness, and ``iterations`` (a tensor)
counts the rounds that ran, as the while-loop does.

The arithmetic is the same on every device, so a run on the card and one on
the CPU agree bit for bit wherever the sweep does: sums over points and small
products go through ``utils/ordered.py``, and Kabsch's 3x3 SVD runs on the
host, in float32, after one copy of the 15 reduced values (an SVD on the
card synchronises with the host as well).  One gate flip moves the
transform by ~1e-5, so reduction order alone would otherwise separate the
two.

Two sweeps serve the cached rounds, as in the JAX package: ``"compact"`` (the
default) moves the rows to sweep to the front
(:func:`ops.nn.nearest_neighbors_active`); ``"inplace"`` leaves them in
place and skips whole blocks with none, on a block table built once per ICP
and shifted by the cloud's drift each round
(:func:`ops.nn.nearest_neighbors_active_inplace`).  ``coarse_stride`` runs a
first, uncached phase on every stride-th point.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.ops.nn import (nearest_neighbors,
                                                       nearest_neighbors_active,
                                                       nearest_neighbors_active_inplace)
from datmo_using_optical_flow_tpu_torch.utils.ordered import (fma32, matmul_terms, norm_rn,
                                                             sqrt_rn, sumsq_fma, tree_sum)

# safety pad (metres) on the per-iteration displacement of the exclusion shell
_DELTA_PAD = 1e-4
# targets at or above this size default to the incremental (cached) search
_CACHED_MIN = 1 << 15


class IcpResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor         # |correspondences| / |valid source|
    inlier_rmse: torch.Tensor
    iterations: torch.Tensor      # rounds the loop ran (int32)
    # (3,) totals over the iterations of [swept rows, certificate-kept rows,
    # exclusion-shell-skipped rows] (zeros on the uncached path)
    sweep_stats: torch.Tensor


def _kabsch_sums(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kabsch's sums over the points, on their device: the flattened 3x3
    cross-covariance (9,) and the weighted centroids of src and dst."""
    wc = w[:, None]
    s1 = tree_sum(torch.cat([wc, src * wc, dst * wc], dim=1))
    wsum = torch.clamp(s1[0], min=1e-12)
    cs = s1[1:4] / wsum
    cd = s1[4:7] / wsum
    s = (src - cs) * wc
    d = dst - cd
    return tree_sum((s[:, :, None] * d[:, None, :]).reshape(-1, 9)), cs, cd


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment src -> dst (rotation and translation, no scale)."""
    h, cs, cd = _kabsch_sums(src, dst, w)
    # the 3x3 solve on the host, in float32
    host = torch.cat([h, cs, cd]).cpu()
    h, cs, cd = host[:9].reshape(3, 3), host[9:12], host[12:15]
    u, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(vt.T @ u.T)
    one = torch.ones_like(det)
    r = vt.T @ torch.diag(torch.stack([one, one, det])) @ u.T
    t = cd - r @ cs
    out = torch.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    if src.device.type == "cuda":  # from pinned memory: the copy does not wait
        return out.pin_memory().to(src.device, non_blocking=True)
    return out.to(src.device)


def transform_points(points: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform ((R @ p) + t, the reference's GMFA.py:77).

    The rotation is the fused multiply-add chain ``fma(z, r2, fma(y, r1,
    x * r0))`` that the JAX package's compiled ``dot`` computes, each step
    rounded once (``ordered.fma32``), so that the card and the CPU round
    it alike."""
    r, t = transformation[:3, :3], transformation[:3, 3]
    x, y, z = (points[:, i:i + 1] for i in range(3))
    acc = x * r[:, 0]
    acc = fma32(y, r[:, 1], acc)
    acc = fma32(z, r[:, 2], acc)
    return acc + t


def _eval_cached(srcf, smask, tgtf, tmask, thr2, transform, cache, live, tgt_index, cap2,
                 sweep):
    """One round of the incremental correspondence search at ``transform``:
    only rows that are neither outside the gate by their moved bound nor
    certified by their carried winner go to ``sweep`` (the signature of
    :func:`nearest_neighbors_active`).  Returns (pts, dst, d2, corr, new
    cache, [swept, certified, excluded] counts)."""
    lo_old, qw, qpos, b2_old = cache
    pts = transform_points(srcf, transform)
    # roots correctly rounded and sums contracted, as JAX's compiled ICP
    # rounds them (its ops/icp.py:109, 118-134)
    delta = norm_rn(pts - qpos) + _DELTA_PAD
    # the sound bound at the last query position, moved by the reverse
    # triangle inequality: rows provably outside the gate skip the sweep
    lo_new = sqrt_rn(lo_old) - delta
    excluded = (lo_new > 0.0) & (lo_new * lo_new > thr2)
    # winner certificate: the carried winner is still the unique nearest
    dw2 = sumsq_fma(pts - qw)
    b2_dec = sqrt_rn(b2_old) - delta
    certified = smask & ~excluded & (sqrt_rn(dw2) + _DELTA_PAD < b2_dec)
    # a frozen round's results are discarded: it sweeps no block
    need = smask & ~excluded & ~certified & live
    _, d2_new, lo_q, b2_q, crd_new = sweep(pts, tgtf, tmask, need, index=tgt_index, cap2=cap2)
    dst = torch.where(need[:, None], crd_new, qw)
    d2 = torch.where(need, d2_new, torch.where(certified, dw2, torch.inf))
    corr = d2 <= thr2
    b2_dec2 = torch.clamp(b2_dec, min=0.0) ** 2
    b2_fresh = torch.where(torch.isfinite(d2_new), b2_q, 0.0)
    cache = (torch.where(need, lo_q, torch.where(certified, dw2, lo_old)),
             dst,
             torch.where((need | certified)[:, None], pts, qpos),
             torch.where(need, b2_fresh, torch.where(certified, b2_dec2, b2_old)))
    counts = torch.stack([torch.sum(need.to(torch.float32)),
                          torch.sum(certified.to(torch.float32)),
                          torch.sum((smask & excluded).to(torch.float32))])
    return pts, dst, d2, corr, cache, counts


def _inplace_sweep(srcf, smask, tgt_index):
    """The in-place sweep for :func:`_eval_cached` (JAX ``_icp_phase``,
    ``ops/icp.py:79-90, 136-147``): the block table is built once, from the
    Morton-ordered cloud with its invalid rows filled as the query fills
    them; each round shifts it by the most any valid row has moved since,
    plus ``_DELTA_PAD``."""
    n = srcf.shape[0]
    src_build = nn_kernels.block_first_fill(srcf, smask, n)[:n]
    block_table = nn_kernels.build_block_table(src_build, tgt_index, n)

    def sweep(pts, tgtf, tmask, need, index, cap2):
        moved = norm_rn(pts - srcf)
        drift = torch.amax(torch.where(smask, moved, 0.0)) + _DELTA_PAD
        return nearest_neighbors_active_inplace(pts, tgtf, tmask, need, index, cap2=cap2,
                                                block_table=block_table, drift=drift)
    return sweep


def _icp_loop(srcf, smask, tgtf, tmask, thr2, relative_fitness, relative_rmse,
              max_iterations, init_transform, cached, tgt_index, cap2, sweep="compact"):
    """The iteration loop from ``init_transform``; returns (transform,
    iterations, eval_full, observables, cache0, stats) like the JAX
    ``_icp_phase``."""
    n = srcf.shape[0]
    dev = srcf.device
    sweep_fn = (_inplace_sweep(srcf, smask, tgt_index) if cached and sweep == "inplace"
                else nearest_neighbors_active)
    n_valid = torch.clamp(torch.sum(smask.to(torch.float32)), min=1.0)
    zero = torch.zeros((), device=dev)

    def eval_full(transform, cache, live):
        # ``live`` (whether the round's result is kept) has no use here: the
        # full query sweeps every row
        pts = transform_points(srcf, transform)
        idx, _ = nearest_neighbors(pts, tgtf, tmask)
        dst = tgtf[idx.long()]
        d2 = sumsq_fma(pts - dst)
        corr = smask & (d2 <= thr2)
        counts = torch.stack([torch.sum(smask.to(torch.float32)), zero, zero])
        return pts, dst, d2, corr, cache, counts

    def eval_cached(transform, cache, live):
        return _eval_cached(srcf, smask, tgtf, tmask, thr2, transform, cache, live, tgt_index,
                            cap2, sweep_fn)

    eval_state = eval_cached if cached else eval_full

    def observables(d2, corr):
        w = corr.to(torch.float32)
        cnt = torch.sum(w)
        fitness = cnt / n_valid
        rmse = sqrt_rn(tree_sum(torch.where(corr, d2, 0.0)) / torch.clamp(cnt, min=1.0))
        return w, cnt, fitness, rmse

    eye = torch.eye(4, device=dev)
    cache0 = (torch.zeros(n, device=dev),                 # d2 lower bound at last query
              torch.zeros((n, 3), device=dev),            # winner coords at last query
              torch.full((n, 3), 1e9, device=dev),        # last query position
              torch.zeros(n, device=dev))                 # second-NN d2 lower bound
    transform, cache = init_transform, cache0
    f1, r1 = zero, zero
    f0, r0 = torch.full((), -1.0, device=dev), torch.full((), -1.0, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    stats = torch.zeros(3, device=dev)
    for _ in range(max_iterations):
        # the while-loop's condition on the current (possibly frozen) state
        keep = (torch.abs(f0 - f1) >= relative_fitness) | (torch.abs(r0 - r1) >= relative_rmse)
        running = (it < max_iterations) & ((it < 2) | keep)
        pts, dst, d2, corr, new_cache, counts = eval_state(transform, cache, running)
        w, cnt, fitness, rmse = observables(d2, corr)
        update = torch.where(cnt >= 3, _kabsch(pts, dst, w), eye)
        transform = torch.where(running, matmul_terms(update, transform), transform)
        f0, r0 = torch.where(running, f1, f0), torch.where(running, r1, r0)
        f1, r1 = torch.where(running, fitness, f1), torch.where(running, rmse, r1)
        cache = tuple(torch.where(running, new, old) for new, old in zip(new_cache, cache))
        stats = torch.where(running, stats + counts, stats)
        it = it + running.to(torch.int32)
    return transform, it, eval_full, observables, cache0, stats


def registration_icp(source: torch.Tensor, source_mask: torch.Tensor, target: torch.Tensor,
                     target_mask: torch.Tensor, threshold: float = 0.02,
                     max_iterations: int = 30, relative_fitness: float = 1e-6,
                     relative_rmse: float = 1e-6, cached: bool | None = None,
                     search_cap: float | None = None,
                     tgt_index: nn_kernels.TargetIndex | None = None,
                     src_order: torch.Tensor | None = None, coarse_stride: int | None = None,
                     sweep: str = "compact") -> IcpResult:
    """ICP from the identity (the reference always passes I, GMFA.py:302).

    ``cached`` (default: on for targets of at least 32,768 points): the
    incremental correspondence search.  A source row whose sound lower bound
    on its NN distance, less its displacement since that bound was measured,
    stays outside ``threshold`` skips the sweep; a row whose carried winner is
    provably still the unique nearest keeps it (winner certificate).  The
    values are those of the full re-query.

    ``search_cap`` (metres; default 5x threshold on the cached path, ``inf``
    disables): the sweep certifies exact neighbours only inside the cap.

    ``tgt_index`` / ``src_order``: a prebuilt target index and source Morton
    order for the cached path (GMFA shares one order per cloud per frame).

    ``coarse_stride`` (default off): a first, uncached phase on every
    ``coarse_stride``-th source and target point (the source strided after
    its Morton permutation), then the full loop from its transform;
    ``iterations`` counts both phases.

    ``sweep``: how the cached rounds visit their rows, ``"compact"`` (active
    rows moved to the front) or ``"inplace"`` (rows in place, whole blocks
    with no active row skipped; a block table built once per ICP).
    """
    if sweep not in ("compact", "inplace"):
        raise ValueError(f"sweep: expected 'compact' or 'inplace', got {sweep!r}")
    srcf = source.to(torch.float32)
    tgtf = target.to(torch.float32)
    smask = source_mask
    thr2 = float(np.float32(threshold * threshold))
    if cached is None:
        cached = target.shape[0] >= _CACHED_MIN
    thr32 = np.float32(threshold)
    if search_cap is None:
        cap = np.float32(5.0) * thr32
    elif not np.isfinite(search_cap):
        cap = None                                         # exact sweep
    else:
        cap = np.float32(search_cap)
    cap2 = None if cap is None else float(np.maximum(cap, thr32) * np.maximum(cap, thr32))

    if cached:
        if tgt_index is None:
            tgt_index = nn_kernels.build_target_index(tgtf, target_mask)
        # the loop runs in Morton-permuted source space: fitness, RMSE and
        # Kabsch are permutation-invariant, and the active prefix of each
        # re-query stays spatially coherent
        morder = (nn_kernels.sort_order(srcf, smask) if src_order is None
                  else src_order).long()
        srcf = srcf[morder]
        smask = smask[morder]
    else:
        tgt_index = None

    t0 = torch.eye(4, device=srcf.device)
    it_c = torch.zeros((), dtype=torch.int32, device=srcf.device)
    if coarse_stride is not None and coarse_stride > 1:
        cs = coarse_stride
        t0, it_c, _, _, _, _ = _icp_loop(
            srcf[::cs], smask[::cs], tgtf[::cs], target_mask[::cs], thr2, relative_fitness,
            relative_rmse, max_iterations, t0, False, None, cap2)
    transform, it, eval_final, observables, cache0, stats = _icp_loop(
        srcf, smask, tgtf, target_mask, thr2, relative_fitness, relative_rmse,
        max_iterations, t0, cached, tgt_index, cap2, sweep)
    # Open3D evaluates the final transform once more; the JAX package always
    # does so through the plain full query
    _, _, d2, corr, _, _ = eval_final(transform, cache0, None)
    _, _, fitness, rmse = observables(d2, corr)
    return IcpResult(transform, fitness, rmse, it_c + it, stats)
