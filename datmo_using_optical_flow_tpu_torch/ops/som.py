"""Static Occupancy Map (SOM) update with exact sequential-clamp semantics,
the counterpart of ``datmo_using_optical_flow_tpu.ops.som``.

The reference (``GMFA/GMFA.py:65-70,134-142``) applies per-point +-0.1
evidence sequentially, clamping to [0.05, 0.95] after each step.  A clipped
add ``v -> min(max(v + a, l), h)`` is closed under composition, so the
triples ``(a, l, h)`` form a monoid:

    compose(t1, t2) = (a1+a2, min(max(l1+a2, l2), h2), min(max(h1+a2, l2), h2))

Hits are stable-sorted by cell (point order kept within a cell), each cell's
sequence is reduced by a segmented inclusive scan of that monoid, and each
cell's last triple is applied to its current value.  torch has no
associative scan: this one is a log-step (Hillis-Steele) scan in plain ops.
Its additions group differently from the JAX package's scan tree, so values
agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

_NEG = -3e38
_POS = 3e38


def point_grid_indices(points: torch.Tensor, grid_size: int, cell_resolution
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row/col per point (``GMFA.py:65-70``): floor-divide with half-grid offset."""
    rx, ry = cell_resolution
    row = torch.floor_divide(points[:, 0] + grid_size * rx / 2.0, rx).to(torch.int32)
    col = torch.floor_divide(points[:, 1] + grid_size * ry / 2.0, ry).to(torch.int32)
    return row, col


def _compose(t1, t2):
    a1, l1, h1 = t1
    a2, l2, h2 = t2
    a = a1 + a2
    lo = torch.minimum(torch.maximum(l1 + a2, l2), h2)
    hi = torch.minimum(torch.maximum(h1 + a2, l2), h2)
    return a, lo, hi


def _segmented_scan(first: torch.Tensor, t: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """Inclusive scan of the clipped-add monoid, restarted where ``first``."""
    n = first.shape[0]
    flag = first
    d = 1
    while d < n:
        prev = tuple(x[:-d] for x in t)
        cur = tuple(x[d:] for x in t)
        comp = _compose(prev, cur)
        fcur = flag[d:]
        # (fx, x) . (fy, y) = (fx | fy, y if fy else x . y)
        t = tuple(torch.cat([x[:d], torch.where(fcur, y, c)])
                  for x, y, c in zip(t, cur, comp))
        flag = torch.cat([flag[:d], flag[:-d] | fcur])
        d *= 2
    return t


def update_som(som: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
               residuals: torch.Tensor, static_threshold: float, moving_threshold: float,
               cell_resolution, increment: float = 0.1, decrement: float = 0.1,
               max_value: float = 0.95, min_value: float = 0.05) -> torch.Tensor:
    """Sequential-exact static/moving evidence accumulation (``GMFA.py:134-142``)."""
    g = som.shape[0]
    row, col = point_grid_indices(points, g, cell_resolution)
    inb = mask & (row >= 0) & (row < g) & (col >= 0) & (col < g)
    static = inb & (residuals < static_threshold)
    moving = inb & (residuals > moving_threshold)
    hit = static | moving  # mid-band residuals are no-ops in the reference
    zero = torch.zeros_like(residuals, dtype=torch.float32)
    delta = torch.where(static, zero + increment, torch.where(moving, zero - decrement, zero))
    cell = torch.where(hit, row * g + col, g * g).to(torch.int32)

    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    delta_s = delta[order]
    is_hit = cell_s < g * g
    a = torch.where(is_hit, delta_s, 0.0)
    lo = torch.where(is_hit, zero + min_value, _NEG)
    hi = torch.where(is_hit, zero + max_value, _POS)

    change = cell_s[1:] != cell_s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=cell.device)
    a_sc, lo_sc, hi_sc = _segmented_scan(torch.cat([one, change]), (a, lo, hi))

    # the last element of each segment carries the cell's full composition
    last = torch.cat([change, one]) & is_hit
    tgt = torch.where(last, cell_s, g * g).long()
    acc_a = torch.zeros(g * g + 1, device=som.device)
    acc_l = torch.full((g * g + 1,), _NEG, device=som.device)
    acc_h = torch.full((g * g + 1,), _POS, device=som.device)
    acc_a[tgt] = a_sc
    acc_l[tgt] = lo_sc
    acc_h[tgt] = hi_sc
    flat = som.reshape(-1)
    out = torch.minimum(torch.maximum(flat + acc_a[:g * g], acc_l[:g * g]), acc_h[:g * g])
    return out.reshape(g, g).to(som.dtype)
