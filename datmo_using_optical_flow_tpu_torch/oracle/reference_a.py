"""The reference's pipeline-A tracking surface in numpy: a copy of the parts
of ``datmo_using_optical_flow_tpu.oracle.reference_a`` that ``compat``
re-exports (``extract_cluster_data``, ``RefEKF``, ``track_clusters``,
``manage_tracks``; ``Optical_flow/main.py:402-515``), so that the port
imports nothing of the JAX package.  Small host-side dicts, quirks kept.
"""

from __future__ import annotations

import numpy as np


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
