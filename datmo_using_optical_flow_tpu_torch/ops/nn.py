"""1-nearest-neighbour queries over padded point sets, the counterpart of
``datmo_using_optical_flow_tpu.ops.nn``.

Every query goes through K5 (:func:`ops.nn_kernels.nearest_neighbors`): the
targets are Morton-sorted into an index, the sources are Morton-permuted so
each 256-row block is spatially compact, and the results are un-permuted.
Tie-breaking uses original target indices, so the permutations change only
how much the sweep prunes, never the results.

Targets above ``MAX_TARGET`` (2^18) points raise: the JAX package's tiled-scan
fallback for them is not ported (GMFA's clouds are 102,400 points).
The JAX package's ``active_cap`` tiers of :func:`nearest_neighbors_active`
(prefix-sized launches that cut TPU grid and table overheads, with the same
values on active rows) are not ported either: the port always sweeps the
stable partition at full width, and blocks past the active prefix exit at
once.
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.ops import nn_kernels


def _require_eligible(m: int) -> None:
    if not nn_kernels.eligible(m):
        raise ValueError(f"{m} target points exceed the NN kernel's limit "
                         f"({nn_kernels.MAX_TARGET}); the JAX package's scan fallback "
                         "for larger targets is not ported")


def _exact_d2(src: torch.Tensor, crd: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """d2 recomputed by direct subtraction at the returned winner (where one
    was found): the sweep value carries the recentred expansion's rounding."""
    diff = src - crd
    exact = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    return torch.where(torch.isfinite(d2), exact, d2)


def nearest_neighbors_with_bound(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                                 cap2=None, tgt_order: torch.Tensor | None = None,
                                 src_order: torch.Tensor | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each ``src`` row: ``(idx, d2, lower_bound)`` of its nearest valid
    target; idx 0 and d2 +inf when there is none.  ``lower_bound`` is sound
    (true NN d2 >= it).  ``cap2``: rows whose true NN d2 is below it are
    exact; other rows return d2 >= cap2 or +inf.  ``tgt_order`` /
    ``src_order``: precomputed Morton permutations (:func:`sort_order`)."""
    _require_eligible(tgt.shape[0])
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
    """
    _require_eligible(tgt.shape[0])
    n = src.shape[0]
    dev = src.device
    srcf = src.to(torch.float32)
    if index is None:
        index = nn_kernels.build_target_index(tgt, tgt_mask)
    act32 = active.to(torch.int32)
    n_active = torch.sum(act32)
    csum = torch.cumsum(act32, dim=0, dtype=torch.int32)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    pos = torch.where(active, csum - 1, n_active + (ar - csum)).long()
    src_c = torch.empty((n, 3), dtype=torch.float32, device=dev)
    src_c[pos] = srcf
    idx_s, d2_s, lo_s, b2_s, crd_s = nn_kernels.nearest_neighbors(src_c, index, n_active, cap2)
    idx = torch.where(active, idx_s[pos], 0)
    d2 = torch.where(active, d2_s[pos], torch.inf)
    lo = torch.where(active, lo_s[pos], torch.inf)
    b2 = torch.where(active, b2_s[pos], 0.0)
    crd = torch.where(active[:, None], crd_s[pos], 0.0)
    d2 = _exact_d2(srcf, crd, d2)
    return idx, d2, torch.minimum(lo, d2), b2, crd
