"""DBSCAN by neighbour counting and min-label propagation, the counterpart of
``datmo_using_optical_flow_tpu.ops.dbscan``.

* pairwise squared distances by the expansion ``|x|^2 + |t|^2 - 2 x.t`` (the
  JAX package's exact formula; the cross term is ``torch.matmul`` in full
  float32, TF32 off);
* core mask = neighbour count (inclusive of self) >= min_samples;
* connected components over the core-core graph by min-hooking plus pointer
  doubling;
* border points attach to the minimum-rooted neighbouring cluster.

Up to ``_FULL_MATRIX_MAX`` padded rows the whole pairwise matrix is held and
the propagation runs a fixed ``max_rounds`` rounds: the body is idempotent at
its fixpoint, so the labels equal the JAX package's early-exit loop, and the
device never waits for the host.  Above it (GMFA's 16,384 moving points) the
distances are recomputed per 512-column tile in every pass, so memory stays
at (N, 512), and the propagation stops at its fixpoint: one host read of a
"changed" flag per round, as the JAX package's while-loop stops.

Cluster ids follow ascending minimum core index (sklearn's order).  Noise and
padding rows are -1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from datmo_using_optical_flow_tpu_torch.utils import device as _device  # noqa: F401  (TF32 off)
from datmo_using_optical_flow_tpu_torch.utils.padding import compact_masked

_TILE = 512
# above this many padded rows the pairwise matrix is tiled
_FULL_MATRIX_MAX = 8192
_INF_I32 = torch.iinfo(torch.int32).max


def _sqdist_tile(feats: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """(N, T) squared euclidean distances via the expansion."""
    xn = torch.sum(feats * feats, dim=1)[:, None]
    tn = torch.sum(tile * tile, dim=1)[None, :]
    cross = torch.matmul(feats, tile.T)
    return torch.clamp(xn + tn - 2.0 * cross, min=0.0)


def dbscan(features: torch.Tensor, valid: torch.Tensor, eps: float, min_samples: int,
           max_rounds: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """DBSCAN on padded ``(N, D)`` features -> ``(labels, core_mask)``.

    Labels are int32, -1 for noise/padding, cluster ids 0..k-1 by ascending
    minimum core index.
    """
    n = features.shape[0]
    pad = (-n) % _TILE
    npad = n + pad
    feats = F.pad(features.to(torch.float32), (0, 0, 0, pad), value=3e18)  # far from all
    validp = F.pad(valid.to(torch.bool), (0, pad))
    eps2 = float(np.float32(eps) * np.float32(eps))  # float32, as the JAX package
    tiled = npad > _FULL_MATRIX_MAX

    if not tiled:
        d2 = _sqdist_tile(feats, feats)
        nbr = (d2 <= eps2) & validp[None, :]
        counts = torch.sum(nbr.to(torch.float32), dim=1)
        core = validp & (counts >= min_samples)
        adjc = nbr & core[None, :]
        del d2, nbr

        def min_rep(rep):
            return torch.amin(torch.where(adjc, rep[None, :], _INF_I32), dim=1)
    else:
        validf = validp.to(torch.float32)
        counts = torch.zeros(npad, device=feats.device)
        for j in range(0, npad, _TILE):
            d2 = _sqdist_tile(feats, feats[j:j + _TILE])
            counts = counts + torch.sum((d2 <= eps2) * validf[None, j:j + _TILE], dim=1)
        core = validp & (counts >= min_samples)

        def min_rep(rep):
            out = torch.full((npad,), _INF_I32, dtype=torch.int32, device=feats.device)
            for j in range(0, npad, _TILE):
                d2 = _sqdist_tile(feats, feats[j:j + _TILE])
                adj = (d2 <= eps2) & core[None, j:j + _TILE]
                cand = torch.amin(torch.where(adj, rep[None, j:j + _TILE], _INF_I32), dim=1)
                out = torch.minimum(out, cand)
            return out

    idx = torch.arange(npad, dtype=torch.int32, device=feats.device)
    rep = torch.where(core, idx, _INF_I32)
    for _ in range(max_rounds):
        new = torch.where(core, torch.minimum(rep, min_rep(rep)), rep)
        # pointer doubling (guard the INF sentinels)
        is_inf = new == _INF_I32
        new2 = torch.where(is_inf, new, new[torch.where(is_inf, 0, new).long()])
        is_inf2 = new2 == _INF_I32
        new3 = torch.where(is_inf2, new2, new2[torch.where(is_inf2, 0, new2).long()])
        changed = bool(torch.any(new3 != rep)) if tiled else True
        rep = new3
        if not changed:
            break

    # attach border points: min root among core neighbours
    point_rep = torch.where(core, rep, min_rep(rep))
    assigned = validp & (point_rep != _INF_I32)

    # compact cluster ids by ascending root index (== sklearn visitation order)
    is_root = core & (rep == idx)
    root_rank = torch.cumsum(is_root.to(torch.int32), dim=0, dtype=torch.int32) - 1
    safe_rep = torch.where(assigned, point_rep, 0).long()
    labels = torch.where(assigned, root_rank[safe_rep], -1).to(torch.int32)
    return labels[:n], core[:n]


def dbscan_velocity_grid(vx: torch.Tensor, vy: torch.Tensor, valid_mask: torch.Tensor,
                         eps: float, min_samples: int, grid_shape: tuple[int, int],
                         max_cells: int):
    """Pipeline-A clustering: features = [row, col, vx, vy] of the masked cells,
    compacted to ``max_cells`` in row-major order.

    Returns ``(labels, rows, cols, cell_mask, count)``.
    """
    h, w = grid_shape
    flat = torch.arange(h * w, dtype=torch.int32, device=vx.device)
    rows = flat // w
    cols = flat % w
    feats_full = torch.stack([rows.to(torch.float32), cols.to(torch.float32),
                              vx.reshape(-1), vy.reshape(-1)], dim=1)
    mask = valid_mask.reshape(-1).to(torch.bool)
    feats, cmask, count = compact_masked(feats_full, mask, max_cells, fill_value=3e18)
    labels, _ = dbscan(feats, cmask, eps, min_samples)
    r = torch.where(cmask, feats[:, 0].to(torch.int32), -1)
    c = torch.where(cmask, feats[:, 1].to(torch.int32), -1)
    return labels, r, c, cmask, count
