"""Pipeline B, the General Model-Free Approach (GMFA), in PyTorch: the
counterpart of ``datmo_using_optical_flow_tpu.models.gmfa``, from PCD files
to the track log.

:meth:`GMFAPipeline.preprocess` turns one frame's padded points into the
expanded cloud (flip x, RANSAC ground removal, ROI, compaction,
densification), with no host synchronisation.  The frame step runs ICP
ego-motion -> residual-motion classification -> moving-point ROI and DBSCAN
-> Hungarian association -> track update and birth -> static occupancy map
-> per-track KF (the reference's ``GMFA/GMFA.py:424-536``), and
:meth:`GMFAPipeline.process_files` runs a PCD sequence end to end.  The
reference quirks the JAX package replicates are kept:

* a frame with zero moving ROI points is skipped without updating the
  previous cloud (GMFA.py:477's ``continue``), on the device: the whole carry
  is kept;
* residuals are index-wise when the cloud sizes match and NN-aligned
  otherwise (GMFA.py:79-91);
* the SOM update pairs moving point k with the full cloud's residual k
  (GMFA.py:491/134);
* unmatched tracks are dropped, and every surviving track KF-updates against
  its own feature centroid (GMFA.py:216-232, :494-497);
* new-track ids are random ints below 1e5 (GMFA.py:252), drawn from the
  step's threefry key with ``prng.randint`` (JAX's draw, bit for bit) on the
  host (:func:`new_track_ids`);
* the birth-velocity lookup refreshes only on frames with a live track
  (GMFA.py:500-523).
"""

from __future__ import annotations

import csv
import os
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.config import GMFAConfig
from datmo_using_optical_flow_tpu_torch.io.frames import DiskFrameSource, dequantize_points_q16
from datmo_using_optical_flow_tpu_torch.ops import nn_kernels
from datmo_using_optical_flow_tpu_torch.ops import points as point_ops
from datmo_using_optical_flow_tpu_torch.ops.dbscan import dbscan
from datmo_using_optical_flow_tpu_torch.ops.hungarian import linear_sum_assignment
from datmo_using_optical_flow_tpu_torch.ops.icp import (_CACHED_MIN, registration_icp,
                                                        transform_points)
from datmo_using_optical_flow_tpu_torch.ops.nn import nearest_neighbors_with_bound
from datmo_using_optical_flow_tpu_torch.ops.ransac import remove_ground
from datmo_using_optical_flow_tpu_torch.ops.som import update_som
from datmo_using_optical_flow_tpu_torch.utils import prng
from datmo_using_optical_flow_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from datmo_using_optical_flow_tpu_torch.utils.device import resolve_device
from datmo_using_optical_flow_tpu_torch.utils.hostpack import HostMirror, HostPacker
from datmo_using_optical_flow_tpu_torch.utils.tree import select, stack
from datmo_using_optical_flow_tpu_torch.utils.ordered import (inv2, matmul_terms, norm_rn,
                                                             segment_sum, sqrt_rn, sumsq_fma)
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


def _gmfa_preprocess_impl(points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
                          cfg: GMFAConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """flip -> RANSAC ground removal -> ROI -> compact -> densify (the
    reference's ``preprocess_pcd``, ``GMFA/GMFA.py:31-55``).  int16 points
    are q16 fixed point, dequantised here."""
    c = cfg
    if points.dtype == torch.int16:
        points = dequantize_points_q16(points)
    kr, kd = prng.split(key)
    p = point_ops.flip_x(points)
    _, non_ground = remove_ground(p, mask, kr, c.ransac.distance_threshold,
                                  c.ransac.ransac_n, c.ransac.num_iterations)
    roi = non_ground & point_ops.roi_mask(p, c.roi_bounds)
    cpts, cmask, _ = compact_masked(p, roi, c.capacities.max_roi_points)
    return point_ops.densify(cpts, cmask, kd, c.capacities.expansion_factor,
                             noise_std=c.noise_std)


def new_track_ids(key: torch.Tensor, k: int, dev: torch.device) -> torch.Tensor:
    """The ``k`` ids a step can give the tracks it births,
    ``randint(key, (k,), 0, 100000)`` as the JAX package draws them, put on
    ``dev``.  The draw runs where ``key`` lies (the int64 code is bit-equal on
    both devices): from a host key, the ~500 small operations of threefry cost
    no launches, and the ids reach the card in one non-blocking copy from
    pinned memory."""
    ids = prng.randint(key, (k,), 0, 100000)
    if ids.is_cuda or dev.type != "cuda":
        return ids.to(dev)
    return ids.pin_memory().to(dev, non_blocking=True)


def _residual_norm(diff: torch.Tensor, same_size: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(points - ref_pts, axis=1)`` as the JAX package's
    compiled step rounds it (JAX ``models/gmfa.py:553-555``), a correctly
    rounded root of: on the NN-aligned branch the contracted sum ``fma(z, z,
    fma(y, y, x * x))``; on the index-wise branch ``(x * x + y * y) + z * z``,
    which is how XLA's CPU code rounds that branch up to 16,384 rows (above
    that it contracts some row ranges and not others)."""
    x, y, z = diff[:, 0], diff[:, 1], diff[:, 2]
    seq = (x * x + y * y) + z * z
    return sqrt_rn(torch.where(same_size, seq, sumsq_fma(diff)))


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
    residuals = _residual_norm(points - ref_pts, same_size)
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
    n_clusters = torch.sum(exists.to(torch.int32)).to(torch.int32)

    # 6. Hungarian association on feature distances (GMFA.py:182-213)
    tb = carry.table
    # JAX models/gmfa.py:586-587 compiled: the difference, the contracted sum
    # and a correct root, fused
    cost = norm_rn(tb.features[:, None, :], feats[None, :, :])
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
    tid = _put(tb.tid, target_slot, new_ids)
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
    """Streaming runner for the GMFA pipeline on one device (the card unless
    the caller passes ``device="cpu"``; without CUDA the default raises)."""

    def __init__(self, cfg: GMFAConfig | None = None, max_moving_points: int = 8192,
                 device: str | torch.device = "cuda"):
        self.cfg = (cfg or GMFAConfig()).validate()
        self.max_moving = max_moving_points
        self.device = resolve_device(device)
        self._kf = _kf_model(self.cfg, self.device)

    def preprocess(self, points: torch.Tensor, mask: torch.Tensor, key: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded points (float32, or int16 q16) and their mask -> the
        expanded cloud and its mask (the reference's ``preprocess_pcd``), all
        on this pipeline's device."""
        return _gmfa_preprocess_impl(points, mask, key, self.cfg)

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
             key: torch.Tensor) -> tuple[GmfaCarry, GmfaOutputs]:
        """One GMFA frame step.  ``key`` (a threefry key, ``utils.prng``)
        draws the ids of the tracks born this frame (:func:`new_track_ids`;
        keep it on the host: a key on the card draws there, ~500 launches).
        A skipped frame returns the old carry values."""
        ids = new_track_ids(key, self.cfg.capacities.max_clusters, self.device)
        return _gmfa_step_impl(points, mask, carry, ids, self.cfg, self.max_moving, self._kf)

    def scan_steps(self, points: torch.Tensor, masks: torch.Tensor, carry: GmfaCarry,
                   seed: int = 0) -> tuple[GmfaCarry, GmfaOutputs]:
        """A (T, P, 3) clip: frame 0 seeds the previous cloud, then T-1 steps.
        Returns the final carry and the T-1 outputs stacked.  Frame i's key
        is ``split(fold_in(PRNGKey(seed), i))[1]``, as :meth:`process_files`
        derives it with seed 0, so the two give the same track ids."""
        carry = self.seed_carry(points[0], masks[0], carry)
        base = prng.PRNGKey(seed)
        outs = []
        for i in range(1, points.shape[0]):
            carry, out = self.step(points[i], masks[i], carry,
                                   prng.split(prng.fold_in(base, i))[1])
            outs.append(out)
        return carry, stack(outs)

    def process_files(self, pcd_files: Sequence[str], output_xlsx: str | None = None,
                      seed: int = 0, progress: bool = False, plot_dir: str | None = None,
                      checkpoint_every: int = 0, checkpoint_path: str | None = None,
                      resume: bool = False, h2d_q16: bool = False) -> dict:
        """Run GMFA over a PCD sequence (the reference's ``__main__``,
        GMFA.py:424-536) and write the track log (:func:`save_tracks_to_excel`).

        Frame i's keys are ``kp, ks = split(fold_in(PRNGKey(seed), i))``:
        ``kp`` preprocesses it and ``ks`` draws its new track ids, as the JAX
        package derives them, so a resumed run continues the uninterrupted
        one bit for bit.  The first frame seeds the carry
        without a step; a skipped frame writes no rows.  With
        ``checkpoint_every=K`` the carry goes to ``checkpoint_path`` (.npz,
        the JAX package's keys) every K frames, after the rows of every frame
        before it; ``resume=True`` restores it and continues from the frame
        it records.  ``h2d_q16`` ships the points as int16 fixed point.
        With ``plot_dir``, the reference's four per-frame plots
        (GMFA.py:525-527 and the positions plot: SOM heat map, moving vs
        static, positions and velocities, final positions) are saved there as
        PNGs, drawn by the writer thread from the packed observables (which
        then also carry the moving cloud and the SOM); without matplotlib the
        run raises before its first frame.

        Each frame's track-log observables are packed on the device into one
        uint8 buffer; a transfer thread copies a drained batch of buffers to
        the host at once and a writer thread turns them into rows, through
        bounded queues.  A thread's first error fails the run.  Returns the
        rows (``Frame`` is ``i - 1``, as the reference logs them), the final
        SOM and carry, the loop's seconds and host seconds per stage (the
        device stages' are launch times: the calls return before the card
        finishes).
        """
        if plot_dir:
            import matplotlib  # noqa: F401  (the plots need it: fail before the first frame)
        c = self.cfg
        dev = self.device
        source = DiskFrameSource(pcd_files, capacity=c.capacities.max_raw_points,
                                 quantize_q16=h2d_q16)
        carry = self.init_carry()
        base = prng.PRNGKey(seed)
        rows: list[dict] = []
        have_prev = False
        start_frame = 0
        if resume and checkpoint_path:
            with np.load(checkpoint_path) as data:
                start_frame = int(data["step"])
            carry = load_checkpoint(checkpoint_path, carry)
            have_prev = True  # the carry holds the previous expanded cloud
            if progress:
                print(f"resumed from {checkpoint_path} at frame {start_frame}")

        timings = {"preprocess": 0.0, "step": 0.0}
        pack, packer = obs_packer(c, self.max_moving if plot_dir else None)

        def log_rows(i: int, obs: dict) -> None:
            if bool(obs["skip"]):
                if progress:
                    print(f"frame {i}: no moving ROI points, skipped")
                return  # the step kept the stale carry (GMFA.py:477)
            alive = obs["alive"].astype(bool)
            for s in np.nonzero(alive)[0]:
                st = obs["state"][s]
                rows.append({"Frame": i - 1, "Track ID": int(obs["tid"][s]),
                             "X": float(st[0]), "Y": float(st[1]),
                             "VX": float(st[2]), "VY": float(st[3])})
            if progress:
                print(f"frame {i}: moving={int(obs['moving_count'])} "
                      f"clusters={int(obs['n_clusters'])} tracks={int(alive.sum())}")
            if plot_dir:
                save_frame_plots(plot_dir, i, obs)

        mirror = HostMirror(packer, log_rows)
        t_start = time.perf_counter()
        try:
            for i, (pts, mask) in enumerate(source):
                if i < start_frame:
                    continue
                kp, ks = prng.split(prng.fold_in(base, i))  # ks stays on the host
                t0 = time.perf_counter()
                ex, exmask = self.preprocess(torch.from_numpy(pts).to(dev),
                                             torch.from_numpy(mask).to(dev), kp.to(dev))
                timings["preprocess"] += time.perf_counter() - t0
                if not have_prev:
                    carry = self.seed_carry(ex, exmask, carry)
                    have_prev = True
                else:
                    t0 = time.perf_counter()
                    carry, out = self.step(ex, exmask, carry, ks)
                    timings["step"] += time.perf_counter() - t0
                    mirror.put(i, pack(out, carry.table, carry.som))
                if checkpoint_every and checkpoint_path and (i + 1) % checkpoint_every == 0:
                    mirror.flush()  # a snapshot never runs ahead of its frames' rows
                    save_checkpoint(checkpoint_path, carry, step=i + 1)
        finally:
            mirror.close()
        mirror.check()
        timings.update(track_log=mirror.seconds["mirror"],
                       track_log_transfer=mirror.seconds["transfer"])
        elapsed = time.perf_counter() - t_start
        if output_xlsx:
            save_tracks_to_excel(rows, output_xlsx)
        return {"rows": rows, "som": carry.som.cpu().numpy(), "carry": carry,
                "elapsed": elapsed, "timings": timings}


TRACK_LOG_COLUMNS = ("Frame", "Track ID", "X", "Y", "VX", "VY")


def save_tracks_to_excel(rows: list[dict], output_file: str = "track_data.xlsx") -> None:
    """The reference's ``save_tracks_to_excel`` (``GMFA.py:419-422``) as the
    JAX package writes it without openpyxl: ``<name>.csv`` beside the
    requested file, header ``Frame,Track ID,X,Y,VX,VY``."""
    path = os.path.splitext(output_file)[0] + ".csv"
    with open(path, "w", newline="") as f:
        out = csv.DictWriter(f, fieldnames=TRACK_LOG_COLUMNS)
        out.writeheader()
        out.writerows(rows)
    print(f"Track data saved to {path}")


def obs_packer(cfg: GMFAConfig, plot_points: int | None = None):
    """``(pack, packer)``: ``pack(outputs, table, som=None)`` puts one frame's
    track-log observables (skip flag, alive, tid and state of every slot,
    the moving-point and cluster counts) into one uint8 buffer on the
    device, in the JAX package's layout; ``packer.unpack`` rebuilds them on
    the host.  With ``plot_points`` (the moving-point capacity) the buffer
    also carries the moving cloud and the SOM, for the per-frame plots."""
    def shrink(out: GmfaOutputs, table: TrackTableB, som: torch.Tensor) -> dict:
        obs = {"skip": out.skip, "alive": table.alive, "tid": table.tid,
               "state": table.state, "moving_count": out.moving_count,
               "n_clusters": out.n_clusters}
        if plot_points:
            obs.update(moving_points=out.moving_points, som=som)
        return obs

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    t, g = cfg.capacities.max_tracks, cfg.som.grid_size
    example = {"skip": meta((), torch.bool), "alive": meta((t,), torch.bool),
               "tid": meta((t,), torch.int32), "state": meta((t, 4), torch.float32),
               "moving_count": meta((), torch.int32), "n_clusters": meta((), torch.int32)}
    if plot_points:
        example.update(moving_points=meta((plot_points, 3), torch.float32),
                       som=meta((g, g), torch.float32))
    packer = HostPacker(example)
    return (lambda out, table, som=None: packer.pack(shrink(out, table, som))), packer


def save_frame_plots(plot_dir: str, frame: int, obs: dict) -> None:
    """The reference's per-frame plots (GMFA.py:525-527: SOM heat map,
    moving vs static, positions and velocities, final moving-object
    detection) as PNGs in ``plot_dir``, from one frame's packed host
    observables (:func:`obs_packer` with ``plot_points``)."""
    from datmo_using_optical_flow_tpu_torch.io import viz

    os.makedirs(plot_dir, exist_ok=True)
    n_mov = int(obs["moving_count"])
    pts = np.asarray(obs["moving_points"])[:n_mov]
    cls = np.full(n_mov, 2)
    states = [obs["state"][s] for s in np.nonzero(obs["alive"].astype(bool))[0]]
    viz.plot_som_heat_map(np.asarray(obs["som"]),
                          save_path=os.path.join(plot_dir, f"som_frame_{frame}.png"))
    viz.plot_moving_vs_static(pts, cls, states, save_path=os.path.join(
        plot_dir, f"moving_static_frame_{frame}.png"))
    viz.visualize_positions_and_velocities(pts, cls, states, save_path=os.path.join(
        plot_dir, f"positions_frame_{frame}.png"))
    viz.visualize_final_positions_and_velocities(
        pts, states, title=f"Frame {frame}: Moving Object Detection",
        save_path=os.path.join(plot_dir, f"final_positions_frame_{frame}.png"))
