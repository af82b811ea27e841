"""The reference's matplotlib plots, a copy of
``datmo_using_optical_flow_tpu.io.viz``: non-blocking by default (saved to a
file; the reference calls a blocking ``plt.show()`` inside its frame loops,
``Optical_flow/main.py:641``, ``GMFA/GMFA.py:526-528``).  matplotlib is
imported on the first plot, with the Agg backend, so that importing this
module needs no matplotlib."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, save_path: str | None, show: bool):
    if save_path:
        fig.savefig(save_path)
    if show:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)


def visualize_tracks(tracks: dict[int, np.ndarray], save_path: str | None = None,
                     show: bool = False) -> None:
    """Final track positions + velocity quivers (``main.py:517-539``)."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 10))
    for tid, state in tracks.items():
        plt.plot(state[0], state[1], "o", label=f"Track {tid}")
        plt.quiver(state[0], state[1], state[2], state[3],
                   angles="xy", scale_units="xy", scale=2, label=f"Velocity {tid}")
    plt.title("Tracked Objects")
    plt.xlabel("X (meters)")
    plt.ylabel("Y (meters)")
    if tracks:
        plt.legend()
    plt.grid()
    _finish(plt, fig, save_path, show)


def visualize_filtered_clusters(labels, indices, vx, vy, x_range, y_range,
                                grid_resolution_x, grid_resolution_y,
                                save_path: str | None = None, show: bool = False) -> None:
    """Cluster quivers in metric coordinates with per-cluster velocity annotations
    (``main.py:336-400``)."""
    plt = _plt()

    labels = np.asarray(labels)
    indices = np.asarray(indices)
    vx = np.asarray(vx)
    vy = np.asarray(vy)
    fig = plt.figure(figsize=(10, 10))
    colormap = plt.get_cmap("tab10")
    unique = np.unique(labels)
    for i, cid in enumerate(unique):
        color = "gray" if cid == -1 else colormap(i % 10)
        m = labels == cid
        pts = indices[m]
        cvx, cvy = vx[m], vy[m]
        plt.quiver(pts[:, 1] * grid_resolution_x + x_range[0],
                   pts[:, 0] * grid_resolution_y + y_range[0],
                   cvx, cvy, angles="xy", scale_units="xy", scale=1, color=color,
                   label="Noise" if cid == -1 else f"Cluster {cid}")
        if cid != -1 and len(cvx):
            avg = float(np.sqrt(np.mean(cvx ** 2 + cvy ** 2)))
            plt.text(float(np.mean(pts[:, 1] * grid_resolution_x + x_range[0])),
                     float(np.mean(pts[:, 0] * grid_resolution_y + y_range[0])),
                     f"ID: {cid}\nVel: {avg:.2f}", color="black", fontsize=8,
                     ha="center")
    if len(unique) <= 10:
        plt.legend(loc="upper right")
    plt.title("Filtered DBSCAN Clusters with Velocities")
    plt.xlabel("X (meters)")
    plt.ylabel("Y (meters)")
    plt.grid()
    _finish(plt, fig, save_path, show)


def plot_moving_vs_static(points, classifications, tracks=None,
                          save_path: str | None = None, show: bool = False) -> None:
    """Static (blue) vs moving (red) scatter + track positions (``GMFA.py:311-336``)."""
    plt = _plt()
    points = np.asarray(points)
    cls = np.asarray(classifications)
    fig = plt.figure(figsize=(10, 10))
    st = points[cls == 3]
    mv = points[cls == 2]
    if len(st):
        plt.scatter(st[:, 0], st[:, 1], c="blue", label="Static Objects", alpha=0.5)
    if len(mv):
        plt.scatter(mv[:, 0], mv[:, 1], c="red", label="Moving Objects", alpha=0.5)
    if tracks:
        pos = np.array([np.asarray(t)[:2] for t in tracks])
        plt.scatter(pos[:, 0], pos[:, 1], c="purple", label="Final Positions",
                    alpha=0.7, s=50)
    plt.title("Moving vs Static Objects")
    plt.xlabel("X Coordinate")
    plt.ylabel("Y Coordinate")
    plt.legend()
    plt.grid(True)
    _finish(plt, fig, save_path, show)


def visualize_positions_and_velocities(points, classifications, track_states,
                                       save_path: str | None = None,
                                       show: bool = False) -> None:
    """Point classes + green velocity quivers per track (``GMFA.py:261-295``)."""
    plt = _plt()
    points = np.asarray(points)
    cls = np.asarray(classifications)
    fig = plt.figure(figsize=(30, 8))
    st = points[cls == 3]
    mv = points[cls == 2]
    if len(st):
        plt.scatter(st[:, 0], st[:, 1], color="blue", label="Static Objects", alpha=0.5)
    if len(mv):
        plt.scatter(mv[:, 0], mv[:, 1], color="red", label="Moving Objects", alpha=0.5)
    for s in track_states:
        s = np.asarray(s).flatten()
        plt.quiver(s[0], s[1], s[2], s[3], angles="xy", scale_units="xy", scale=1,
                   color="green", width=0.002)
    plt.title("Frame Visualization")
    plt.xlabel("X")
    plt.ylabel("Y")
    plt.legend()
    plt.grid(True)
    _finish(plt, fig, save_path, show)


def visualize_final_positions_and_velocities(points, track_states,
                                             title: str = "Moving Object Detection",
                                             save_path: str | None = None,
                                             show: bool = False) -> None:
    """Point cloud (gray) with final track positions overlaid (``GMFA.py:337-366``).

    Behavioral note: despite its name and docstring, the reference function
    never draws the velocity quiver — it sets a ``velocity_vector_plotted``
    flag that nothing reads and only scatters the position of each track
    (``GMFA.py:349-360``).  Replicated behavior-for-behavior: gray cloud +
    blue 'Target Vehicle' positions, one legend entry.
    """
    plt = _plt()
    points = np.asarray(points)
    fig = plt.figure(figsize=(10, 10))
    if len(points):
        plt.scatter(points[:, 0], points[:, 1], c="gray", s=1, label="Point Cloud")
    for k, s in enumerate(track_states):
        s = np.asarray(s).flatten()
        plt.scatter(s[0], s[1], color="blue", alpha=0.8, s=50,
                    label="Target Vehicle" if k == 0 else None)
    plt.title(title)
    plt.xlabel("X Coordinate")
    plt.ylabel("Y Coordinate")
    plt.legend()
    plt.grid(True)
    _finish(plt, fig, save_path, show)


def plot_filtered_cloud(points, classifications, save_path: str | None = None,
                        show: bool = False) -> None:
    """Static/moving scatter (``GMFA.py:386-406``)."""
    plot_moving_vs_static(points, classifications, None, save_path, show)


def plot_som_heat_map(som_grid, save_path: str | None = None, show: bool = False) -> None:
    """Occupancy heat map (``GMFA.py:409-416``)."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 10))
    plt.imshow(np.asarray(som_grid), cmap="hot", interpolation="nearest")
    plt.colorbar(label="Occupancy Probability")
    plt.title("SOM Heat Map")
    plt.xlabel("Grid X")
    plt.ylabel("Grid Y")
    _finish(plt, fig, save_path, show)
