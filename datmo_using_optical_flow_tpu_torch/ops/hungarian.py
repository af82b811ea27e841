"""Exact linear-sum assignment (Jonker-Volgenant shortest augmenting path),
the counterpart of ``datmo_using_optical_flow_tpu.ops.hungarian``.

The matrices are tiny (tracks x clusters, 64 x 32 at most in GMFA) and the
algorithm is a sequential loop with data-dependent exits, so the solve runs
on the host: :func:`linear_sum_assignment` copies the cost matrix and masks
off the device once, solves in float32 numpy with the JAX package's exact
operation order, and returns its results on the input's device.  That is
one device-to-host copy and one host-to-device copy per call, however many
loop steps the solve takes.

Tie-breaking between equal-cost optima depends on the problem solved, so the
16 x 16 compacted tier runs under the same condition as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = np.float32(3e38)
# compacted-tier capacity: both masked counts must fit for the small solve
_COMPACT_CAP = 16


def _solve_square_np(cost: np.ndarray) -> np.ndarray:
    """col4row (n,) int32 for a square float32 cost matrix."""
    n = cost.shape[0]
    cost = cost.astype(np.float32)
    u = np.zeros(n, np.float32)
    v = np.zeros(n + 1, np.float32)
    p = np.full(n + 1, -1, np.int32)  # p[j] = row matched to column j; column n is virtual
    for i in range(n):
        p[n] = i
        minv = np.full(n + 1, _INF, np.float32)
        minv[n] = -_INF  # the virtual column is never picked again
        used = np.zeros(n + 1, bool)
        way = np.zeros(n + 1, np.int32)
        j0 = n
        while p[j0] != -1:
            used[j0] = True
            i0 = p[j0]
            cur = (cost[i0, :] - u[i0]) - v[:n]
            improve = (~used[:n]) & (cur < minv[:n])
            minv[:n] = np.where(improve, cur, minv[:n])
            way[:n] = np.where(improve, j0, way[:n])
            masked = np.where(used[:n], _INF, minv[:n])
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            rows = p[used]  # each used column has its own matched row
            u[rows] = u[rows] + delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0 = j1
        while j0 != n:  # augment along the alternating path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col4row = np.zeros(n, np.int32)
    col4row[p[:n]] = np.arange(n, dtype=np.int32)
    return col4row


def solve_square(cost: torch.Tensor) -> torch.Tensor:
    """Assignment for a square (n, n) cost matrix -> col4row (n,) int32."""
    return torch.as_tensor(_solve_square_np(cost.detach().cpu().numpy()), device=cost.device)


def _lsa_np(cost: np.ndarray, row_mask: np.ndarray | None, col_mask: np.ndarray | None):
    r, c = cost.shape
    cost = cost.astype(np.float32)
    finite = np.isfinite(cost)
    if row_mask is not None:
        finite = finite & row_mask[:, None]
    if col_mask is not None:
        finite = finite & col_mask[None, :]
    big = np.float32(np.max(np.where(finite, cost, np.float32(0.0))) + np.float32(1.0))
    masked_cost = np.where(finite, cost, big).astype(np.float32)

    def solve_full():
        if r <= c:
            padded = np.zeros((c, c), np.float32)
            padded[:r, :c] = masked_cost
            return _solve_square_np(padded)[:r]
        # transpose so every real column gets a row, then invert
        padded = np.zeros((r, r), np.float32)
        padded[:c, :r] = masked_cost.T
        row4col = _solve_square_np(padded)[:c]
        out = np.full(r, c, np.int32)
        out[row4col] = np.arange(c, dtype=np.int32)
        return out

    def solve_small():
        k = _COMPACT_CAP

        def first_valid(mask):
            idx = np.nonzero(mask)[0][:k]
            okay = np.zeros(k, bool)
            okay[:len(idx)] = True
            return np.pad(idx, (0, k - len(idx))).astype(np.int32), okay

        ridx, rok = first_valid(row_mask)
        cidx, cok = first_valid(col_mask)
        sub = np.where(rok[:, None] & cok[None, :], masked_cost[ridx][:, cidx], big)
        subcol = np.clip(_solve_square_np(sub), 0, k - 1)
        mapped = np.where(cok[subcol], cidx[subcol], c)
        out = np.full(r, c, np.int32)
        out[ridx[rok]] = mapped[rok]
        return out

    if (row_mask is not None and col_mask is not None and min(r, c) > _COMPACT_CAP
            and row_mask.sum() <= _COMPACT_CAP and col_mask.sum() <= _COMPACT_CAP):
        col4row = solve_small()
    else:
        col4row = solve_full()
    inb = col4row < c
    cc = np.clip(col4row, 0, c - 1)
    valid = inb & (masked_cost[np.arange(r), cc] < big)
    if row_mask is not None:
        valid = valid & row_mask
    if col_mask is not None:
        valid = valid & col_mask[cc]
    return col4row, valid


def linear_sum_assignment(cost: torch.Tensor, row_mask: torch.Tensor | None = None,
                          col_mask: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked rectangular assignment over a padded (R, C) cost matrix.

    Returns ``(col4row (R,) int32, valid (R,) bool)``: ``valid`` marks rows
    that got a real (unmasked-column) partner.  Masked and slack entries are
    padded with ``max(real cost) + 1``, so the real sub-assignment stays
    optimal in float32.
    """
    dev = cost.device
    host = [None if t is None else t.detach().cpu().numpy()
            for t in (cost, row_mask, col_mask)]
    col4row, valid = _lsa_np(*host)
    return torch.as_tensor(col4row, device=dev), torch.as_tensor(valid, device=dev)
