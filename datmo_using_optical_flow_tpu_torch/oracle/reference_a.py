"""The reference's pipeline-A CPU oracle in numpy (``Optical_flow/main.py``).

A copy of the parts of ``datmo_using_optical_flow_tpu.oracle.reference_a``
that ``compat`` re-exports (``extract_cluster_data``, ``RefEKF``,
``track_clusters``, ``manage_tracks``; ``main.py:402-515``) and that the
quality benchmark's oracle loop runs (``velocity_from_flow``,
``continuity_mask``, ``dbscan_clustering``, ``farneback_flow``), so that the
port imports nothing of the JAX package.  Every function is verbatim but
``farneback_flow``, which runs the numpy model of cv2
(``np_farneback.calc_flow``) where the JAX oracle calls cv2: the card's
machine has no cv2.  Small host-side dicts, quirks kept.
"""

from __future__ import annotations

import numpy as np

from datmo_using_optical_flow_tpu_torch.oracle.np_farneback import calc_flow


def farneback_flow(bev1: np.ndarray, bev2: np.ndarray, params: dict | None = None) -> np.ndarray:
    """The reference's flow with the hard-coded params of ``main.py:132-142``,
    as ``cv2.calcOpticalFlowFarneback`` computes it, through the numpy model
    of cv2 (``np_farneback.calc_flow``, which the JAX package's tests pin to
    cv2 at < 1e-3 px EPE).  ``flags`` may hold cv2's
    ``OPTFLOW_FARNEBACK_GAUSSIAN`` (256) and nothing else."""
    p = dict(pyr_scale=0.3, levels=5, winsize=15, iterations=5, poly_n=5,
             poly_sigma=5, flags=0)
    if params:
        p.update(params)
    flags = p.pop("flags")
    if flags & ~256:
        raise ValueError(f"flags {flags}: only OPTFLOW_FARNEBACK_GAUSSIAN (256) is modelled")
    return calc_flow(bev1.astype(np.float32), bev2.astype(np.float32),
                     gaussian=bool(flags & 256), **p)


def velocity_from_flow(flow: np.ndarray, x_range, y_range) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flow px/frame → m/s scaling + curl angular velocity (``main.py:143-164``).
    Note the reference's pixel_size uses shape[1] for x and shape[0] for y and
    ignores dt in the scaling — replicated as-is."""
    vx_px, vy_px = flow[..., 0], flow[..., 1]
    pixel_size_x = (x_range[1] - x_range[0]) / flow.shape[1]
    pixel_size_y = (y_range[1] - y_range[0]) / flow.shape[0]
    velocity_x = vx_px * pixel_size_x
    velocity_y = vy_px * pixel_size_y
    dvx_dy, dvx_dx = np.gradient(velocity_x)
    dvy_dy, dvy_dx = np.gradient(velocity_y)
    angular_velocity = dvy_dx - dvx_dy
    return velocity_x, velocity_y, angular_velocity


def continuity_mask(vx: np.ndarray, vy: np.ndarray, alpha_cont: float) -> np.ndarray:
    """|div| and |curl| gate via np.gradient stencils (``main.py:224-228``)."""
    div_v = np.gradient(vx, axis=1) + np.gradient(vy, axis=0)
    curl_v = np.gradient(vy, axis=1) - np.gradient(vx, axis=0)
    return ((np.abs(div_v) <= alpha_cont) & (np.abs(curl_v) <= alpha_cont)).astype(int)


def dbscan_clustering(vx_f: np.ndarray, vy_f: np.ndarray, valid_mask: np.ndarray,
                      eps: float = 5.0, min_samples: int = 3):
    """sklearn DBSCAN on [row, col, vx, vy] features (``main.py:231-259``)."""
    from sklearn.cluster import DBSCAN

    valid_indices = np.array(np.nonzero(valid_mask)).T
    features = np.column_stack((valid_indices, vx_f[valid_mask.astype(bool)],
                                vy_f[valid_mask.astype(bool)]))
    if features.shape[0] == 0:
        return np.empty((0,), dtype=np.int64), valid_indices
    labels = DBSCAN(eps=eps, min_samples=min_samples).fit(features).labels_
    return labels, valid_indices


def extract_cluster_data(labels, indices, vx, vy):
    """Per-cluster centroid / measurement / covariance eigenvalues (``main.py:402-434``)."""
    clusters = {}
    for label in np.unique(labels):
        if label == -1:
            continue
        m = labels == label
        pts = indices[m]
        cvx = vx[pts[:, 0], pts[:, 1]]
        cvy = vy[pts[:, 0], pts[:, 1]]
        centroid = pts.mean(axis=0)
        cov = np.cov(pts.T)
        eig = np.linalg.eigvals(cov)
        clusters[int(label)] = {
            "centroid": centroid,
            "measurement": [centroid[0], centroid[1], cvx.mean(), cvy.mean()],
            "eigenvalues": eig,
        }
    return clusters


class RefEKF:
    """The reference's quirky 4-state EKF (``main.py:437-467``): unicycle-ish predict
    with a constant-velocity F, and H = I₄ update — internally inconsistent state
    semantics preserved on purpose (SURVEY.md §2.1 A12)."""

    def __init__(self, state, process_noise, measurement_noise):
        self.state = np.array(state, dtype=np.float64)
        self.P = np.eye(4)
        self.Q = process_noise
        self.R = measurement_noise
        self.F = np.eye(4)
        self.H = np.eye(4)

    def predict(self, dt, u):
        v, omega = u
        theta = self.state[2]
        self.F[0, 2] = dt
        self.F[1, 3] = dt
        self.state[0] += self.state[3] * np.cos(theta) * dt
        self.state[1] += self.state[3] * np.sin(theta) * dt
        self.state[2] += omega * dt
        self.state[3] += v * dt
        self.P = self.F @ self.P @ self.F.T + self.Q

    def update(self, z):
        y = z - self.H @ self.state
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.state = self.state + K @ y
        self.P = (np.eye(4) - K @ self.H) @ self.P


def track_clusters(tracks: dict, clusters: dict, dt, process_noise, measurement_noise,
                   gamma: float) -> dict:
    """Greedy GNN association + EKF update (``main.py:468-506``), quirks preserved:
    clusters iterate in key order; several clusters may claim the same track (the
    shared EKF object is predicted/updated once per claimant, last claimant kept);
    all new tracks in a frame share the id ``max(old_keys)+1`` (last one survives);
    unmatched old tracks are dropped."""
    new_tracks = {}
    for _, cluster in sorted(clusters.items()):
        cluster_feature = np.array([*cluster["centroid"], *cluster["eigenvalues"]],
                                   dtype=np.float64)
        matched, best = None, float("inf")
        for track_id, ekf in tracks.items():
            track_feature = np.array([ekf.state[0], ekf.state[1], 0.0, 0.0])
            dist = np.linalg.norm(cluster_feature - track_feature)
            if dist < best and dist < gamma:
                matched, best = track_id, dist
        if matched is not None:
            ekf = tracks[matched]
            ekf.predict(dt, cluster["measurement"][2:])
            ekf.update(np.asarray(cluster["measurement"], dtype=np.float64))
            new_tracks[matched] = ekf
        else:
            new_id = max(tracks.keys(), default=0) + 1
            new_tracks[new_id] = RefEKF(cluster["measurement"], process_noise,
                                        measurement_noise)
    return new_tracks


def manage_tracks(tracks, track_lifetimes, confirmed_tracks, M1, N1, M2, N2):
    """M/N confirm-then-delete lifecycle (``main.py:507-515``)."""
    for track_id in list(tracks.keys()):
        life = track_lifetimes[track_id]
        if track_id in confirmed_tracks:
            if life > N2 and life - M2 <= N2:
                del tracks[track_id]
        else:
            if life >= N1 and life - M1 <= N1:
                confirmed_tracks.add(track_id)
