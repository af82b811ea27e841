"""1-nearest-neighbour queries over padded point sets, the counterpart of
``datmo_using_optical_flow_tpu.ops.nn``.

Every query goes through K5 (:func:`ops.nn_kernels.nearest_neighbors`): the
targets are Morton-sorted into an index, the sources are Morton-permuted so
each 256-row block is spatially compact, and the results are un-permuted.
Tie-breaking uses original target indices.  The source permutation decides
each row's block, and so the point the sweep recentres that row on: two
targets within the sweep's error envelope of each other may then swap, so a
row's winner can differ between two queries that block it differently (1
row of 16,384 when those rows were queried alone, against the same rows of
a 102,400-row query, on uniform clouds of 102,400 points).  The same query
gives the same results on the card and the CPU.

Targets above ``nn_kernels.MAX_TARGET`` (2^18) points go to
:func:`nearest_neighbors_scan`, the JAX package's tiled scan: one plain
float32 matrix product per 512-target tile (``torch.matmul``, TF32 off as
``utils/device`` sets it) with a running minimum, exact (it ignores
``cap2``), and with :func:`_scan_lower_bound`'s error envelope as its lower
bound.  GMFA's clouds (102,400 points) stay on K5.
The JAX package's ``active_cap`` tiers of :func:`nearest_neighbors_active`
(prefix-sized launches that cut TPU grid and table overheads, with the same
values on active rows) are not ported either: the port always sweeps the
stable partition at full width, and blocks past the active prefix exit at
once.
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.utils.ordered import fma32, sumsq_fma


_TILE = 512  # targets per tile of the scan


def _exact_d2(src: torch.Tensor, crd: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """d2 recomputed by direct subtraction at the returned winner (where one
    was found): the sweep value carries the recentred expansion's rounding.
    The sum is JAX's compiled ``jnp.sum(diff * diff, axis=1)`` (JAX
    ``ops/nn.py:83-84``), contracted: ``ordered.sumsq_fma``."""
    return torch.where(torch.isfinite(d2), sumsq_fma(src - crd), d2)


def _exact_d2_seq(src: torch.Tensor, crd: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """:func:`_exact_d2` as JAX's active queries round it (JAX ``ops/nn.py:
    275-276, 363-364``: there XLA does not contract the sum):
    ``(x * x + y * y) + z * z``."""
    diff = src - crd
    seq = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    return torch.where(torch.isfinite(d2), seq, d2)


def nearest_neighbors_with_bound(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                                 cap2=None, tgt_order: torch.Tensor | None = None,
                                 src_order: torch.Tensor | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each ``src`` row: ``(idx, d2, lower_bound)`` of its nearest valid
    target; idx 0 and d2 +inf when there is none.  ``lower_bound`` is sound
    (true NN d2 >= it).  ``cap2``: rows whose true NN d2 is below it are
    exact; other rows return d2 >= cap2 or +inf.  ``tgt_order`` /
    ``src_order``: precomputed Morton permutations (:func:`sort_order`).
    Targets above ``nn_kernels.MAX_TARGET`` take the exact scan, with its
    envelope as the bound (``cap2`` and the orders are not used there)."""
    if not nn_kernels.eligible(tgt.shape[0]):
        idx, d2 = nearest_neighbors_scan(src, tgt, tgt_mask)
        return idx, d2, _scan_lower_bound(src, tgt, tgt_mask, d2)
    n = src.shape[0]
    srcf = src.to(torch.float32)
    index = nn_kernels.build_target_index(tgt, tgt_mask, order=tgt_order)
    order = (torch.argsort(nn_kernels._morton_keys(srcf), stable=True)
             if src_order is None else src_order.long())
    idx_s, d2_s, lo_s, _, crd_s = nn_kernels.nearest_neighbors(srcf[order], index, cap2=cap2)
    inv = torch.empty(n, dtype=torch.int64, device=src.device)
    inv[order] = torch.arange(n, device=src.device)
    idx, d2, lo, crd = idx_s[inv], d2_s[inv], lo_s[inv], crd_s[inv]
    d2 = _exact_d2(srcf, crd, d2)
    return idx, d2, torch.minimum(lo, d2)


def nearest_neighbors(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, d2)`` of each ``src`` row's nearest valid target (idx 0 and
    d2 +inf when there is none)."""
    idx, d2, _ = nearest_neighbors_with_bound(src, tgt, tgt_mask)
    return idx, d2


def nearest_neighbors_active(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                             active: torch.Tensor, index: nn_kernels.TargetIndex | None = None,
                             cap2=None):
    """1-NN of the ``active`` source rows only (the cached-ICP sweep).

    Returns ``(idx, d2, lower_bound, second_lower_bound, coords)``: active rows
    get what the full query returns; inactive rows idx 0 / +inf / +inf / 0 /
    zeros.  Active rows move to the front by a stable partition (one cumsum;
    the destination array is its own inverse permutation), so a
    Morton-sorted ``src`` keeps its active prefix spatially coherent, and the
    sweep is told the active count, so blocks past the prefix skip it.
    Targets above ``nn_kernels.MAX_TARGET`` take the full scan with masked
    outputs, as the JAX package's fallback: no savings, and the second
    bound is 0 (it never certifies).
    """
    srcf = src.to(torch.float32)
    if not nn_kernels.eligible(tgt.shape[0]):
        idx, d2, lo = nearest_neighbors_with_bound(src, tgt, tgt_mask)
        crd = torch.where(torch.isfinite(d2)[:, None], tgt.to(torch.float32)[idx.long()], 0.0)
        return (torch.where(active, idx, 0), torch.where(active, d2, torch.inf),
                torch.where(active, lo, torch.inf), torch.zeros_like(d2),
                torch.where(active[:, None], crd, 0.0))
    if index is None:
        index = nn_kernels.build_target_index(tgt, tgt_mask)
    src_c, pos, n_active = partition_active(srcf, active)
    res = nn_kernels.nearest_neighbors(src_c, index, n_active, cap2)
    idx, d2, lo, b2, crd = unpartition(res, pos, active)
    d2 = _exact_d2_seq(srcf, crd, d2)
    return idx, d2, torch.minimum(lo, d2), b2, crd


def nearest_neighbors_active_inplace(src: torch.Tensor, tgt: torch.Tensor,
                                     tgt_mask: torch.Tensor, active: torch.Tensor,
                                     index: nn_kernels.TargetIndex, cap2=None,
                                     block_table=None, drift=None):
    """1-NN of the ``active`` source rows with no row movement (ICP's
    ``sweep="inplace"``, JAX ``ops/nn.py:327-372``): ``src`` should already be
    in Morton order, and a 256-row block with no active row skips the sweep.
    Inactive rows of a mixed block are rewritten to the block's first active
    row (``nn_kernels.block_first_fill``) so its bounding ball stays tight;
    their results are discarded.  Returns what
    :func:`nearest_neighbors_active` returns; no gather and no partition.
    ``block_table`` / ``drift``: a table built once for the cloud and the most
    any row moved since (see ``nn_kernels.nearest_neighbors``)."""
    src_clean, counts = inplace_inputs(src, active)
    idx, d2, lo, d2nd, crd = nn_kernels.nearest_neighbors(
        src_clean, index, cap2=cap2, block_counts=counts, block_table=block_table, drift=drift)
    d2 = _exact_d2_seq(src.to(torch.float32), crd, d2)  # JAX :363-365, not contracted
    lo = torch.minimum(lo, d2)
    return (torch.where(active, idx, 0), torch.where(active, d2, torch.inf),
            torch.where(active, lo, torch.inf), torch.where(active, d2nd, 0.0),
            torch.where(active[:, None], crd, 0.0))


def inplace_inputs(src: torch.Tensor, active: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The in-place query's sweep input: the (N, 3) rows with each inactive
    row rewritten to its block's first active row, and the (n_blocks,) int32
    active count of each 256-row block."""
    n = src.shape[0]
    b = nn_kernels.SRC_BLOCK
    counts = torch.nn.functional.pad(active, (0, (-n) % b)).to(torch.int32).reshape(-1, b)
    return (nn_kernels.block_first_fill(src, active, n)[:n],
            torch.sum(counts, dim=1, dtype=torch.int32))


def partition_active(srcf: torch.Tensor, active: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable partition of the (N, 3) rows, active rows first: returns the
    partitioned rows, each row's destination ``pos`` (int64) and the active
    count (0-d int32)."""
    n = srcf.shape[0]
    act32 = active.to(torch.int32)
    n_active = torch.sum(act32)
    csum = torch.cumsum(act32, dim=0, dtype=torch.int32)
    ar = torch.arange(n, dtype=torch.int32, device=srcf.device)
    pos = torch.where(active, csum - 1, n_active + (ar - csum)).long()
    src_c = torch.empty((n, 3), dtype=torch.float32, device=srcf.device)
    src_c[pos] = srcf
    return src_c, pos, n_active


def unpartition(res, pos: torch.Tensor, active: torch.Tensor):
    """The sweep's five outputs on the partitioned rows back in row order;
    inactive rows get idx 0 / +inf / +inf / 0 / zeros."""
    idx_s, d2_s, lo_s, b2_s, crd_s = res
    return (torch.where(active, idx_s[pos], 0),
            torch.where(active, d2_s[pos], torch.inf),
            torch.where(active, lo_s[pos], torch.inf),
            torch.where(active, b2_s[pos], 0.0),
            torch.where(active[:, None], crd_s[pos], 0.0))


def nearest_neighbors_scan(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx int32, d2)`` of each ``src`` row's nearest valid target by a
    scan over 512-target tiles (JAX ``ops/nn.nearest_neighbors_scan``, the
    fallback above ``nn_kernels.MAX_TARGET``): d2 by the expansion ``|s|^2 +
    |t|^2 - 2 s.t`` (one matrix product per tile), clamped at 0; the first
    tile's minimum wins a tie between tiles and the lowest index one within a
    tile.  idx 0 and d2 +inf when there is no valid target."""
    n, m = src.shape[0], tgt.shape[0]
    dev = src.device
    pad = (-m) % _TILE
    tgt_p = torch.cat([tgt.to(torch.float32),
                       torch.full((pad, 3), 3e18, dtype=torch.float32, device=dev)])
    mask_p = torch.cat([tgt_mask.to(torch.bool), torch.zeros(pad, dtype=torch.bool, device=dev)])
    srcf = src.to(torch.float32)
    sn = sumsq_fma(srcf)
    best_d = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int32, device=dev)
    for j in range(0, m + pad, _TILE):
        tile, tm = tgt_p[j:j + _TILE], mask_p[j:j + _TILE]
        # JAX ops/nn.py:112-119: (sn + tn) rounded, then less 2 dot (exact
        # scaling), one more rounding; both norms contracted, as XLA does
        d2 = (sn[:, None] + sumsq_fma(tile)[None, :]) - 2.0 * (srcf @ tile.T)
        d2 = torch.where(tm[None, :], torch.clamp(d2, min=0.0), torch.inf)
        td, ti = torch.amin(d2, dim=1), torch.argmin(d2, dim=1)
        take = td < best_d
        best_d = torch.where(take, td, best_d)
        best_i = torch.where(take, ti.to(torch.int32) + j, best_i)
    return best_i, best_d


def _scan_lower_bound(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                      d2: torch.Tensor) -> torch.Tensor:
    """A sound lower bound on the true NN d2 under the scan's d2: the
    expansion's absolute error is bounded by ~10 ulp of (|s|^2 + max |t|^2).
    Rounded as JAX's ``nearest_neighbors_with_bound`` compiles it (JAX
    ``ops/nn.py:94-96``): contracted norms, ``fma(2e-6, sn + max tn, 1e-6)``."""
    sn = sumsq_fma(src.to(torch.float32))
    tn = torch.where(tgt_mask, sumsq_fma(tgt.to(torch.float32)), 0.0)
    env = fma32(sn + torch.max(tn), 2e-6, 1e-6)
    return torch.clamp(d2 - env, min=0.0)


def align_by_nearest(points: torch.Tensor, reference: torch.Tensor,
                     ref_mask: torch.Tensor) -> torch.Tensor:
    """Each point replaced by its nearest valid reference point (the
    reference's NN "alignment" of clouds of different sizes, GMFA.py:84-91)."""
    idx, _ = nearest_neighbors(points, reference, ref_mask)
    return reference[idx.long()]
