"""Pipeline B, the General Model-Free Approach (GMFA), in PyTorch: the
counterpart of ``datmo_using_optical_flow_tpu.models.gmfa`` for the frame
step on preprocessed (expanded) clouds.

ICP ego-motion -> residual-motion classification -> moving-point ROI and
DBSCAN -> Hungarian association -> track update and birth -> static
occupancy map -> per-track KF (the reference's ``GMFA/GMFA.py:424-536``).
The reference quirks the JAX package replicates are kept:

* a frame with zero moving ROI points is skipped without updating the
  previous cloud (GMFA.py:477's ``continue``), on the device: the whole carry
  is kept;
* residuals are index-wise when the cloud sizes match and NN-aligned
  otherwise (GMFA.py:79-91);
* the SOM update pairs moving point k with the full cloud's residual k
  (GMFA.py:491/134);
* unmatched tracks are dropped, and every surviving track KF-updates against
  its own feature centroid (GMFA.py:216-232, :494-497);
* new-track ids are random ints below 1e5 (GMFA.py:252): here from the
  pipeline's ``torch.Generator``, or passed in as ``new_ids``;
* the birth-velocity lookup refreshes only on frames with a live track
  (GMFA.py:500-523).

Preprocessing (RANSAC ground removal), the file runner and its artifacts are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import GMFAConfig
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.ops import points as point_ops
from datmo_using_optical_flow_tpu_torch.ops.dbscan import dbscan
from datmo_using_optical_flow_tpu_torch.ops.hungarian import linear_sum_assignment
from datmo_using_optical_flow_tpu_torch.ops.icp import (_CACHED_MIN, registration_icp,
                                                        transform_points)
from datmo_using_optical_flow_tpu_torch.ops.nn import nearest_neighbors_with_bound
from datmo_using_optical_flow_tpu_torch.ops.som import update_som
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device
from datmo_using_optical_flow_tpu_torch.utils.tree import select, stack
from datmo_using_optical_flow_tpu_torch.utils.ordered import inv2, matmul_terms, segment_sum
from datmo_using_optical_flow_tpu_torch.utils.padding import compact_masked


class TrackTableB(NamedTuple):
    state: torch.Tensor     # (T, 4) [x, y, vx, vy]
    cov: torch.Tensor       # (T, 4, 4)
    features: torch.Tensor  # (T, 4) [cx, cy, lmax, lmin]
    tid: torch.Tensor       # (T,) int32
    age: torch.Tensor       # (T,) int32
    alive: torch.Tensor     # (T,) bool


def new_track_table_b(capacity: int, device: str | torch.device = "cpu") -> TrackTableB:
    return TrackTableB(
        state=torch.zeros((capacity, 4), device=device),
        cov=torch.zeros((capacity, 4, 4), device=device),
        features=torch.zeros((capacity, 4), device=device),
        tid=torch.zeros(capacity, dtype=torch.int32, device=device),
        age=torch.zeros(capacity, dtype=torch.int32, device=device),
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


class GmfaCarry(NamedTuple):
    prev_points: torch.Tensor     # (P, 3) previous expanded cloud
    prev_mask: torch.Tensor       # (P,)
    table: TrackTableB
    som: torch.Tensor             # (G, G)
    prev_centroids: torch.Tensor  # (K, 2) previous frame's cluster centroids
    prev_exists: torch.Tensor     # (K,)
    # (P,) int32 Morton order of prev_points: reused by ICP's source
    # permutation and the classification sweep's target index (results do not
    # depend on it, only pruning tightness does)
    prev_order: torch.Tensor


class GmfaOutputs(NamedTuple):
    skip: torch.Tensor             # bool: no moving ROI points (frame skipped)
    classifications: torch.Tensor  # (P,) int32 in {0 (pad), 1, 2, 3}
    residuals: torch.Tensor        # (P,)
    moving_points: torch.Tensor    # (M, 3) compacted moving ROI points
    moving_count: torch.Tensor
    labels: torch.Tensor           # (M,) DBSCAN labels of the moving points
    n_clusters: torch.Tensor
    transformation: torch.Tensor   # (4, 4) ICP ego-motion
    fitness: torch.Tensor


def _put(dest: torch.Tensor, slots: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``dest.at[slots].set(values, mode="drop")`` for slots in [0, len(dest)]:
    slot len(dest) is dropped."""
    ext = torch.cat([dest, dest[:1]])
    ext[slots.long()] = values.to(dest.dtype)
    return ext[:-1]


def _cluster_features(points: torch.Tensor, labels: torch.Tensor, k: int):
    """[cx, cy, lmax, lmin] per cluster from the 3-D point covariance (ddof=1),
    replicating ``calculate_feature_vector`` (GMFA.py:164-169).  The segment
    sums are ordered (``utils/ordered.py``): the centroids seed the track
    table, which carries them from frame to frame."""
    valid = labels >= 0
    lab = torch.where(valid, labels, k).long()

    def seg(x):
        return segment_sum(x, lab, k)

    cnt = seg(valid.to(torch.float32))
    safe = torch.clamp(cnt, min=1.0)
    sums = seg(torch.where(valid[:, None], points, 0.0))
    mean = sums / safe[:, None]
    dev_ = torch.where(valid[:, None], points - mean[torch.clamp(lab, 0, k - 1)], 0.0)
    outer = dev_[:, :, None] * dev_[:, None, :]
    cov = seg(outer.reshape(-1, 9)).reshape(k, 3, 3)
    cov = cov / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    eig = torch.linalg.eigvalsh(cov)  # ascending
    feats = torch.stack([mean[:, 0], mean[:, 1], eig[:, 2], eig[:, 0]], dim=1)
    return feats, mean[:, :2], cnt > 0, cnt


class _KfModel(NamedTuple):
    f: torch.Tensor   # (4, 4) constant-velocity transition
    q: torch.Tensor   # (4, 4) process noise
    h: torch.Tensor   # (2, 4) position measurement
    r: torch.Tensor   # (2, 2) measurement noise


def _kf_model(cfg: GMFAConfig, dev: torch.device) -> _KfModel:
    dt = cfg.dt
    f = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    h = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    return _KfModel(
        f=torch.as_tensor(f, device=dev),
        q=torch.as_tensor(np.diag(np.asarray(cfg.kf_process_noise, np.float32)), device=dev),
        h=torch.as_tensor(h, device=dev),
        r=torch.as_tensor(np.eye(2, dtype=np.float32) * np.float32(cfg.kf_measurement_noise),
                          device=dev))


def _gmfa_step_impl(points: torch.Tensor, mask: torch.Tensor, carry: GmfaCarry,
                    new_ids: torch.Tensor, cfg: GMFAConfig, max_moving: int,
                    kfm: _KfModel) -> tuple[GmfaCarry, GmfaOutputs]:
    c = cfg
    dev = points.device
    n_cur = torch.sum(mask.to(torch.int32))
    n_prev = torch.sum(carry.prev_mask.to(torch.int32))

    # one Morton sort of the new cloud per frame, shared by this frame's ICP
    # target index and classification sweep and, carried, by the next frame's
    share = nn_kernels.eligible(points.shape[0])
    cur_order = nn_kernels.sort_order(points, mask) if share else None
    icp_share = share and points.shape[0] >= _CACHED_MIN
    cur_index = (nn_kernels.build_target_index(points, mask, order=cur_order)
                 if icp_share else None)

    # 1. ICP ego-motion: previous -> current (GMFA.py:465)
    icp = registration_icp(carry.prev_points, carry.prev_mask, points, mask,
                           c.icp.threshold, c.icp.max_iterations, c.icp.relative_fitness,
                           c.icp.relative_rmse, tgt_index=cur_index,
                           src_order=carry.prev_order if icp_share else None)
    prev_t = transform_points(carry.prev_points, icp.transformation)

    # 2. residuals, index-wise when sizes match, NN-aligned otherwise
    # (GMFA.py:79-91).  Every consumer thresholds at or below the moving
    # threshold, so the sweep is capped at twice it: farther rows keep the
    # moving label with residual := the cap
    cls_cap = float(np.float32(2.0) * np.float32(c.moving_threshold))
    idx, d2s, _ = nearest_neighbors_with_bound(
        points, prev_t, carry.prev_mask, cap2=float(np.float32(cls_cap) * np.float32(cls_cap)),
        tgt_order=carry.prev_order if share else None, src_order=cur_order)
    aligned = prev_t[idx.long()]
    same_size = n_cur == n_prev
    ref_pts = torch.where(same_size, prev_t, aligned)
    diff = points - ref_pts
    residuals = torch.sqrt((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
                           + diff[:, 2] * diff[:, 2])
    residuals = torch.where(same_size | torch.isfinite(d2s), residuals, cls_cap)
    residuals = torch.where(mask, residuals, 0.0)

    # 3. classification 3/2/1 (GMFA.py:127-130); 0 marks padding
    cls = torch.where(residuals < c.static_threshold, 3,
                      torch.where(residuals > c.moving_threshold, 2, 1))
    cls = torch.where(mask, cls, 0).to(torch.int32)

    # 4. moving-point ROI (GMFA.py:472-473) and compaction
    moving = (cls == 2) & point_ops.roi_mask_2d(points, c.moving_roi_bounds)
    mpts, mmask, mcount = compact_masked(points, moving, max_moving)
    skip = mcount == 0

    # 5. DBSCAN on the raw 3-D moving points (GMFA.py:480)
    labels, _ = dbscan(mpts, mmask, c.dbscan.eps, c.dbscan.min_samples)
    kmax = c.capacities.max_clusters
    feats, centroids2d, exists, _ = _cluster_features(mpts, labels, kmax)
    n_clusters = torch.sum(exists.to(torch.int32))

    # 6. Hungarian association on feature distances (GMFA.py:182-213)
    tb = carry.table
    fd = tb.features[:, None, :] - feats[None, :, :]
    cost = torch.sqrt(torch.clamp(torch.sum(fd * fd, dim=-1), min=0.0))
    col4row, pair_ok = linear_sum_assignment(cost, row_mask=tb.alive, col_mask=exists)
    ci = torch.clamp(col4row, 0, kmax - 1).long()
    cap = tb.alive.shape[0]
    assigned = pair_ok & (cost[torch.arange(cap, device=dev), ci] < c.cost_threshold)

    # 7. update matched tracks; drop unmatched (GMFA.py:216-232, :487)
    new_pos = centroids2d[ci]
    vel = (new_pos - tb.state[:, :2]) / c.dt
    state = torch.where(assigned[:, None], torch.cat([new_pos, vel], dim=1), tb.state)
    features = torch.where(assigned[:, None], feats[ci], tb.features)
    age = torch.where(assigned, tb.age + 1, tb.age)
    alive = assigned  # only matched tracks survive

    # 8. births from unassigned clusters (GMFA.py:235-258): the j-th
    # unassigned cluster takes the j-th free slot
    claimed = _put(torch.zeros(kmax, dtype=torch.bool, device=dev),
                   torch.where(assigned, ci, kmax), torch.ones(cap, dtype=torch.bool, device=dev))
    unassigned = exists & ~claimed
    free = ~alive
    birth_rank = torch.cumsum(unassigned.to(torch.int32), 0) - 1
    free_idx = torch.cumsum(free.to(torch.int32), 0) - 1
    slot_of_rank = _put(torch.full((kmax + 1,), cap, dtype=torch.int32, device=dev),
                        torch.where(free & (free_idx <= kmax), free_idx, kmax + 1),
                        torch.arange(cap, dtype=torch.int32, device=dev))
    target_slot = torch.where(unassigned, slot_of_rank[torch.clamp(birth_rank, 0, kmax).long()],
                              cap)
    birth_vel = torch.where(carry.prev_exists[:, None],
                            (centroids2d - carry.prev_centroids) / c.dt, 0.0)
    birth_state = torch.cat([centroids2d, birth_vel], dim=1)
    state = _put(state, target_slot, birth_state)
    features = _put(features, target_slot, feats)
    init_cov = torch.eye(4, device=dev) * c.initial_covariance
    cov = _put(tb.cov, target_slot, init_cov.expand(kmax, 4, 4))
    tid = _put(tb.tid, target_slot, new_ids.to(torch.int32))
    age = _put(age, target_slot, torch.ones(kmax, dtype=torch.int32, device=dev))
    born = _put(torch.zeros(cap, dtype=torch.bool, device=dev), target_slot, unassigned)
    alive = alive | born

    # 9. SOM update with the reference's misaligned (moving point k, residual k)
    if residuals.shape[0] >= max_moving:
        som_res = residuals[:max_moving]
    else:
        som_res = torch.nn.functional.pad(residuals, (0, max_moving - residuals.shape[0]))
    som_mask = mmask & (torch.arange(max_moving, device=dev) < n_cur)
    som = update_som(carry.som, mpts, som_mask, som_res, c.static_threshold,
                     c.moving_threshold, c.som.cell_resolution, c.som.static_increment,
                     c.som.moving_decrement, c.som.max_value, c.som.min_value)

    # 10. KF predict + update per live track against its own feature
    # (GMFA.py:494-497), batched over the table, products term by term
    mm = matmul_terms
    xp = mm(kfm.f, state[:, :, None])
    pp = mm(mm(kfm.f, cov), kfm.f.T) + kfm.q
    y = features[:, :2, None] - mm(kfm.h, xp)
    s = mm(mm(kfm.h, pp), kfm.h.T) + kfm.r
    kk = mm(mm(pp, kfm.h.T), inv2(s))
    kf_state = (xp + mm(kk, y))[:, :, 0]
    kf_cov = mm(torch.eye(4, device=dev) - mm(kk, kfm.h), pp)
    state = torch.where(alive[:, None], kf_state, state)
    cov = torch.where(alive[:, None, None], kf_cov, cov)
    table = TrackTableB(state=state, cov=cov, features=features, tid=tid,
                        age=age.to(torch.int32), alive=alive)

    # 11. previous positions refresh only when tracks exist (indentation quirk)
    any_tracks = torch.any(alive)
    prev_centroids = torch.where(any_tracks, centroids2d, carry.prev_centroids)
    prev_exists = torch.where(any_tracks, exists, carry.prev_exists)

    advanced = GmfaCarry(prev_points=points, prev_mask=mask, table=table, som=som,
                         prev_centroids=prev_centroids, prev_exists=prev_exists,
                         prev_order=cur_order if cur_order is not None else carry.prev_order)
    new_carry = select(skip, carry, advanced)
    outputs = GmfaOutputs(skip=skip, classifications=cls, residuals=residuals,
                          moving_points=mpts, moving_count=mcount, labels=labels,
                          n_clusters=n_clusters, transformation=icp.transformation,
                          fitness=icp.fitness)
    return new_carry, outputs


class GMFAPipeline:
    """Streaming runner for the GMFA step on one device (the card unless the
    caller passes ``device="cpu"``; without CUDA the default raises).

    ``seed`` seeds the ``torch.Generator`` (on ``device``) that draws new
    track ids when :meth:`step` is not given them.
    """

    def __init__(self, cfg: GMFAConfig | None = None, max_moving_points: int = 8192,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.cfg = (cfg or GMFAConfig()).validate()
        self.max_moving = max_moving_points
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._kf = _kf_model(self.cfg, self.device)

    def init_carry(self) -> GmfaCarry:
        c = self.cfg
        dev = self.device
        p = c.capacities.max_expanded_points
        g = c.som.grid_size
        k = c.capacities.max_clusters
        return GmfaCarry(
            prev_points=torch.full((p, 3), 1e9, device=dev),
            prev_mask=torch.zeros(p, dtype=torch.bool, device=dev),
            table=new_track_table_b(c.capacities.max_tracks, dev),
            som=torch.full((g, g), c.som.init_value, device=dev),
            prev_centroids=torch.zeros((k, 2), device=dev),
            prev_exists=torch.zeros(k, dtype=torch.bool, device=dev),
            prev_order=torch.arange(p, dtype=torch.int32, device=dev),
        )

    def seed_carry(self, points: torch.Tensor, mask: torch.Tensor,
                   carry: GmfaCarry | None = None) -> GmfaCarry:
        """Seed the previous-cloud slots (the reference's first frame,
        GMFA.py:455-463) with the cloud's Morton order, which the first
        step's pruning relies on."""
        if carry is None:
            carry = self.init_carry()
        return carry._replace(prev_points=points, prev_mask=mask,
                              prev_order=nn_kernels.sort_order(points, mask))

    def step(self, points: torch.Tensor, mask: torch.Tensor, carry: GmfaCarry,
             new_ids: torch.Tensor | None = None) -> tuple[GmfaCarry, GmfaOutputs]:
        """One GMFA frame step.  ``new_ids`` ((max_clusters,) int32): the ids
        given to tracks born this frame; drawn from the pipeline's generator
        when absent.  A skipped frame returns the old carry values."""
        if new_ids is None:
            new_ids = torch.randint(0, 100000, (self.cfg.capacities.max_clusters,),
                                    generator=self.generator, device=self.device,
                                    dtype=torch.int32)
        return _gmfa_step_impl(points, mask, carry, new_ids, self.cfg, self.max_moving,
                               self._kf)

    def scan_steps(self, points: torch.Tensor, masks: torch.Tensor, carry: GmfaCarry,
                   new_ids: torch.Tensor | None = None) -> tuple[GmfaCarry, GmfaOutputs]:
        """A (T, P, 3) clip: frame 0 seeds the previous cloud, then T-1 steps.
        Returns the final carry and the T-1 outputs stacked; ``new_ids``
        ((T-1, max_clusters)) optional, as for :meth:`step`."""
        carry = self.seed_carry(points[0], masks[0], carry)
        outs = []
        for i in range(1, points.shape[0]):
            carry, out = self.step(points[i], masks[i], carry,
                                   None if new_ids is None else new_ids[i - 1])
            outs.append(out)
        return carry, stack(outs)
