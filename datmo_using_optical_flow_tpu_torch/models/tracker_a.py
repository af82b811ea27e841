"""Pipeline-A tracking: fixed-capacity track table, quirk-exact EKF, greedy GNN.

The counterpart of ``datmo_using_optical_flow_tpu.models.tracker_a``, with the
same reference quirks (see that module): predict treats state[2:4] as
(theta, speed) and update as (vx, vy); several clusters may claim one track,
each predicting and updating it in turn; all new tracks of a frame share one id
``max(old ids, default=0) + 1`` and only the last survives; unmatched tracks are
dropped; a reborn id inherits its ghost slot's lifetime.

The JAX ``lax.scan`` over cluster slots is a Python loop of tensor ops here:
no ``.item()`` and no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from datmo_using_optical_flow_tpu_torch.utils import device as _device  # noqa: F401  (TF32 off)
from datmo_using_optical_flow_tpu_torch.utils.ordered import fma32, norm_rn, sqrt_rn


class TrackTable(NamedTuple):
    """Fixed-capacity track table (the device analogue of the ``tracks`` dict)."""

    state: torch.Tensor      # (T, 4)
    cov: torch.Tensor        # (T, 4, 4)
    tid: torch.Tensor        # (T,) int32 — reference dict keys
    alive: torch.Tensor      # (T,) bool
    lifetime: torch.Tensor   # (T,) int32
    confirmed: torch.Tensor  # (T,) bool


def new_track_table(capacity: int, device: torch.device | str = "cpu") -> TrackTable:
    return TrackTable(
        state=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
        cov=torch.zeros((capacity, 4, 4), dtype=torch.float32, device=device),
        tid=torch.zeros((capacity,), dtype=torch.int32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        lifetime=torch.zeros((capacity,), dtype=torch.int32, device=device),
        confirmed=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


class Clusters(NamedTuple):
    """Per-slot cluster data."""

    exists: torch.Tensor       # (K,) bool
    centroid: torch.Tensor     # (K, 2) [row, col]
    measurement: torch.Tensor  # (K, 4) [crow, ccol, mean vx, mean vy]
    eigenvalues: torch.Tensor  # (K, 2)


def extract_clusters(labels: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                     vx: torch.Tensor, vy: torch.Tensor, max_clusters: int) -> Clusters:
    """Per-cluster centroid, measurement and covariance eigenvalues.

    Segment sums are one-hot float32 matmuls (TF32 off), so integer row and
    column sums are exact.  A one-cell cluster has NaN eigenvalues (ddof=1
    covariance of one point), as in the reference.
    """
    k = max_clusters
    valid = labels >= 0
    lab = torch.where(valid, labels, k).long()
    onehot = (lab[:, None] == torch.arange(k, device=labels.device)[None, :]).to(torch.float32)

    def seg(vals):
        return torch.matmul(vals, onehot)

    ones = valid.to(torch.float32)
    r = rows.to(torch.float32)
    c = cols.to(torch.float32)
    ri = torch.clamp(rows, min=0).long()
    ci = torch.clamp(cols, min=0).long()
    w = vx[ri, ci]
    u = vy[ri, ci]
    cnt, sum_r, sum_c, sum_w, sum_u = seg(torch.stack([
        ones, torch.where(valid, r, 0.0), torch.where(valid, c, 0.0),
        torch.where(valid, w, 0.0), torch.where(valid, u, 0.0)]))
    safe = torch.clamp(cnt, min=1.0)
    mr, mc = sum_r / safe, sum_c / safe
    mw, mu = sum_w / safe, sum_u / safe

    # ddof=1 covariance of (row, col) like np.cov
    slot = torch.clamp(lab, 0, k - 1)
    dr = torch.where(valid, r - mr[slot], 0.0) * ones
    dc = torch.where(valid, c - mc[slot], 0.0) * ones
    srr, scc, src = seg(torch.stack([dr * dr, dc * dc, dr * dc]))
    denom = cnt - 1.0
    ok2 = denom > 0
    safe_denom = torch.where(ok2, denom, 1.0)
    a = torch.where(ok2, srr / safe_denom, float("nan"))
    d = torch.where(ok2, scc / safe_denom, float("nan"))
    b = torch.where(ok2, src / safe_denom, float("nan"))
    half_tr = (a + d) * 0.5
    half_diff = (a - d) * 0.5
    # JAX tracker_a.py:108, compiled: sqrt_rn(max(fma(b, b, hd * hd), 0))
    disc = sqrt_rn(torch.clamp(fma32(b, b, half_diff * half_diff), min=0.0))
    eig = torch.stack([half_tr + disc, half_tr - disc], dim=1)

    return Clusters(exists=cnt > 0, centroid=torch.stack([mr, mc], dim=1),
                    measurement=torch.stack([mr, mc, mw, mu], dim=1), eigenvalues=eig)


def _ekf_predict(state, cov, dt, u, q):
    """Reference EKF.predict, quirks preserved."""
    v, omega = u[0], u[1]
    theta = state[2]
    f = torch.eye(4, dtype=state.dtype, device=state.device)
    # fill_ passes dt as a kernel argument; item assignment would copy it from
    # the host and synchronise
    f[0, 2].fill_(dt)
    f[1, 3].fill_(dt)
    new_state = torch.stack([
        state[0] + state[3] * torch.cos(theta) * dt,
        state[1] + state[3] * torch.sin(theta) * dt,
        state[2] + omega * dt,
        state[3] + v * dt,
    ])
    new_cov = f @ cov @ f.T + q
    return new_state, new_cov


def _ekf_update(state, cov, z, r):
    """Reference EKF.update: H = I4.  ``inv_ex`` does not wait for the host to
    learn whether the matrix was singular."""
    k = cov @ torch.linalg.inv_ex(cov + r).inverse
    new_state = state + k @ (z - state)
    new_cov = (torch.eye(4, dtype=state.dtype, device=state.device) - k) @ cov
    return new_state, new_cov


def associate_and_update(table: TrackTable, clusters: Clusters, dt: float,
                         q_scale: float, r_scale: float, gamma: float) -> TrackTable:
    """``track_clusters``: cluster slots in order, each matching its nearest
    alive track (by [row, col, eig1, eig2] against [row, col, 0, 0]) within
    ``gamma``, or opening the frame's one new track."""
    cap = table.state.shape[0]
    dev = table.state.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    q = eye * q_scale
    r = eye * r_scale

    old_alive = table.alive
    new_id = torch.amax(torch.where(old_alive, table.tid, 0)) + 1
    # the one reserved slot for this frame's new track: prefer a ghost slot
    # carrying the same recycled id (it inherits lifetime and confirmation)
    free_slots = ~old_alive
    ghost = free_slots & (table.tid == new_id) & (table.lifetime > 0)
    inherits = torch.any(ghost)
    # indices stay 1-element tensors: a 0-d index tensor would be read back
    # to the host as a Python int
    new_slot = torch.where(inherits, torch.argmax(ghost.to(torch.uint8), 0, keepdim=True),
                           torch.argmax(free_slots.to(torch.uint8), 0, keepdim=True))
    has_free = torch.any(free_slots)

    state = table.state.clone()
    cov = table.cov.clone()
    in_new = torch.zeros((cap,), dtype=torch.bool, device=dev)
    created = torch.zeros((1,), dtype=torch.bool, device=dev)
    feats = torch.cat([clusters.centroid, clusters.eigenvalues], dim=1)  # (K, 4)
    for j in range(clusters.exists.shape[0]):
        exists, meas = clusters.exists[j], clusters.measurement[j]
        track_feat = torch.cat([state[:, :2], torch.zeros((cap, 2), device=dev)], dim=1)
        diff = feats[j][None, :] - track_feat
        # JAX tracker_a.py:169 compiled: the contracted sum, a correct root
        dist = norm_rn(diff)
        dist = torch.where(old_alive, dist, float("inf"))
        best = torch.argmin(dist, 0, keepdim=True)  # (1,)
        matched = exists & (dist[best] < gamma)     # (1,)

        # matched: predict with u = measurement[2:4], then update
        ps, pc = _ekf_predict(state[best][0], cov[best][0], dt, meas[2:4], q)
        us, uc = _ekf_update(ps, pc, meas, r)
        state[best] = torch.where(matched[:, None], us[None], state[best])
        cov[best] = torch.where(matched[:, None, None], uc[None], cov[best])
        in_new[best] = in_new[best] | matched

        # unmatched: fresh EKF in the reserved slot (overwrites earlier ones)
        make_new = exists & ~matched & has_free     # (1,)
        state[new_slot] = torch.where(make_new[:, None], meas[None], state[new_slot])
        cov[new_slot] = torch.where(make_new[:, None, None], eye[None], cov[new_slot])
        in_new[new_slot] = in_new[new_slot] | make_new
        created = created | make_new

    is_new_slot = created & (torch.arange(cap, device=dev) == new_slot)
    tid = torch.where(is_new_slot, new_id, table.tid)
    # a non-inheriting birth starts with clean lifecycle state in its slot
    reset = is_new_slot & ~inherits
    lifetime = torch.where(reset, 0, table.lifetime)
    confirmed = torch.where(reset, False, table.confirmed)
    return table._replace(state=state, cov=cov, tid=tid.to(torch.int32), alive=in_new,
                          lifetime=lifetime.to(torch.int32), confirmed=confirmed)


def lifecycle(table: TrackTable, m1: int, n1: int, m2: int, n2: int) -> TrackTable:
    """Lifetime bookkeeping and ``manage_tracks``: lifetimes of alive tracks
    increment, dead slots go to 0 except those deleted this frame (ghosts keep
    their lifetime into the next frame); confirmation is per slot, forever."""
    alive = table.alive
    lifetime = torch.where(alive, table.lifetime + 1, 0).to(torch.int32)
    confirmed = table.confirmed
    delete = alive & confirmed & (lifetime > n2) & (lifetime - m2 <= n2)
    confirm = alive & ~confirmed & (lifetime >= n1) & (lifetime - m1 <= n1)
    return table._replace(alive=alive & ~delete, lifetime=lifetime,
                          confirmed=confirmed | confirm)


def track_step(table: TrackTable, clusters: Clusters, dt: float, q_scale: float,
               r_scale: float, gamma: float, m1: int, n1: int, m2: int,
               n2: int) -> TrackTable:
    """One full tracking step: association + EKF + lifecycle (``main.py:618-634``)."""
    table = associate_and_update(table, clusters, dt, q_scale, r_scale, gamma)
    return lifecycle(table, m1, n1, m2, n2)
