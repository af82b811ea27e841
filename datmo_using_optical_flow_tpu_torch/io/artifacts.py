"""Artifact sink with the reference's ``saving_utils.py`` output, a copy of
``datmo_using_optical_flow_tpu.io.artifacts``.

Writes the same files as the JAX package (``tests/test_torch_io.py`` holds
them byte-equal):

* ``bev_frame_<i>.npy`` (+ grayscale ``.png``)
* ``velocity_{x,y}_frame_<i>.npy`` (+ quiver ``.png``)
* ``dbscan_labels/indices_frame_<i>.npy`` (+ scatter ``.png``)
* ``ekf_tracks_frame_<i>.yaml`` (+ quiver ``.png``)
* per-cell filtered-velocity and per-track velocity CSV rows
* ``print_final_track_velocities``

The GPU deployment has no pyyaml, so :func:`yaml_tracks` writes the YAML text
that ``yaml.dump`` writes for a ``{track id: [floats]}`` mapping, and
:func:`read_yaml_tracks` reads it back as ``yaml.safe_load`` does.  PNGs
(matplotlib, imported when first drawn) are optional (``save_png``).
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _yaml_float(v: float) -> str:
    """PyYAML's plain scalar for a Python float (``represent_float``)."""
    if v != v:
        return ".nan"
    if v in (float("inf"), float("-inf")):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def yaml_tracks(track_data: dict[int, list[float]]) -> str:
    """``yaml.dump(track_data)`` for int keys and float lists: block style,
    keys sorted, sequences not indented under their key."""
    if not track_data:
        return "{}\n"
    lines = []
    for tid in sorted(track_data):
        lines.append(f"{tid}:")
        lines.extend(f"- {_yaml_float(v)}" for v in track_data[tid])
    return "\n".join(lines) + "\n"


_YAML_SPECIAL = {".nan": float("nan"), ".inf": float("inf"), "-.inf": float("-inf")}


def read_yaml_tracks(text: str) -> dict[int, list[float]]:
    """The inverse of :func:`yaml_tracks`: ``yaml.safe_load`` of an
    ``ekf_tracks_frame_<i>.yaml`` (int keys, block lists of floats).  Raises
    ValueError on any other YAML."""
    if text.strip() in ("{}", ""):
        return {}
    out: dict[int, list[float]] = {}
    values = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("- ") and values is not None:
            item = line[2:].strip()
            values.append(_YAML_SPECIAL[item] if item in _YAML_SPECIAL else float(item))
        elif line.endswith(":") and not line.startswith((" ", "-")):
            values = out.setdefault(int(line[:-1]), [])
        else:
            raise ValueError(f"not a track mapping line: {line!r}")
    return out


class ArtifactSink:
    def __init__(self, output_dir: str, save_png: bool = True,
                 filtered_csv_name: str = "filtered_velocities.csv",
                 tracks_csv_name: str = "track_velocities.csv"):
        self.output_dir = output_dir
        self.save_png = save_png
        os.makedirs(output_dir, exist_ok=True)
        self.filtered_csv = os.path.join(output_dir, filtered_csv_name)
        self.tracks_csv = os.path.join(output_dir, tracks_csv_name)
        # reference removes the tracks CSV at start to begin fresh (main.py:556-558)
        for p in (self.filtered_csv, self.tracks_csv):
            if os.path.exists(p):
                os.remove(p)

    def _plt(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def save_bev(self, bev: np.ndarray, frame_index: int) -> None:
        np.save(os.path.join(self.output_dir, f"bev_frame_{frame_index}.npy"), bev)
        if self.save_png:
            plt = self._plt()
            plt.imsave(os.path.join(self.output_dir, f"bev_frame_{frame_index}.png"),
                       bev, cmap="gray")

    def save_velocity_grid(self, vx: np.ndarray, vy: np.ndarray, frame_index: int) -> None:
        np.save(os.path.join(self.output_dir, f"velocity_x_frame_{frame_index}.npy"), vx)
        np.save(os.path.join(self.output_dir, f"velocity_y_frame_{frame_index}.npy"), vy)
        if self.save_png:
            plt = self._plt()
            fig = plt.figure(figsize=(10, 10))
            plt.quiver(vx, vy, angles="xy", scale_units="xy", scale=1, color="blue")
            plt.title(f"Velocity Vectors for Frame {frame_index}")
            plt.xlabel("X")
            plt.ylabel("Y")
            plt.savefig(os.path.join(self.output_dir,
                                     f"velocity_grid_frame_{frame_index}.png"))
            plt.close(fig)

    def save_dbscan_results(self, labels: np.ndarray, valid_indices: np.ndarray,
                            frame_index: int) -> None:
        np.save(os.path.join(self.output_dir, f"dbscan_labels_frame_{frame_index}.npy"),
                labels)
        np.save(os.path.join(self.output_dir, f"dbscan_indices_frame_{frame_index}.npy"),
                valid_indices)
        if self.save_png and len(valid_indices):
            plt = self._plt()
            fig = plt.figure(figsize=(10, 10))
            plt.scatter(valid_indices[:, 1], valid_indices[:, 0], c=labels,
                        cmap="tab20", s=5)
            plt.title(f"DBSCAN Clustering for Frame {frame_index}")
            plt.xlabel("X")
            plt.ylabel("Y")
            plt.savefig(os.path.join(self.output_dir, f"dbscan_frame_{frame_index}.png"))
            plt.close(fig)

    def save_ekf_tracks(self, tracks: dict[int, np.ndarray], frame_index: int) -> None:
        track_data = {int(tid): [float(v) for v in state]
                      for tid, state in tracks.items()}
        with open(os.path.join(self.output_dir,
                               f"ekf_tracks_frame_{frame_index}.yaml"), "w") as f:
            f.write(yaml_tracks(track_data))
        if self.save_png:
            plt = self._plt()
            fig = plt.figure(figsize=(10, 10))
            for tid, state in tracks.items():
                plt.plot(state[0], state[1], "o", label=f"Track {tid}")
                plt.quiver(state[0], state[1], state[2], state[3],
                           angles="xy", scale_units="xy", scale=1,
                           label=f"Velocity {tid}")
            plt.title(f"EKF Tracks for Frame {frame_index}")
            plt.xlabel("X (meters)")
            plt.ylabel("Y (meters)")
            if tracks:
                plt.legend()
            plt.grid()
            plt.savefig(os.path.join(self.output_dir,
                                     f"ekf_tracks_frame_{frame_index}.png"))
            plt.close(fig)

    def append_filtered_velocities(self, vx_f: np.ndarray, vy_f: np.ndarray,
                                   magnitude: np.ndarray, angular: np.ndarray,
                                   frame_index: int) -> None:
        """Per-cell rows [frame, idx, vx, vy, |v|, omega] for nonzero cells
        (saving_utils.py:17-46)."""
        file_exists = os.path.exists(self.filtered_csv)
        ii, jj = np.nonzero((vx_f != 0) | (vy_f != 0))
        with open(self.filtered_csv, "a", newline="") as f:
            w = csv.writer(f)
            if not file_exists:
                w.writerow(["Frame Index", "Point Index", "Filtered X Velocity",
                            "Filtered Y Velocity", "Magnitude", "Angular Velocity"])
            # C-accelerated csv.writer over the gathered 1-D columns (str() of
            # np.float32 == the reference's exact cell formatting,
            # saving_utils.py:40-46); this is the hottest host-side artifact
            w.writerows(
                [frame_index, idx, a, b, c, d]
                for idx, (a, b, c, d) in enumerate(zip(
                    vx_f[ii, jj], vy_f[ii, jj], magnitude[ii, jj],
                    angular[ii, jj])))

    def append_track_velocities(self, tracks: dict[int, np.ndarray],
                                frame_index: int) -> None:
        """Per-track rows (saving_utils.py:80-105; 'angular velocity' = state[1],
        replicating the reference's own comment-acknowledged misuse)."""
        file_exists = os.path.exists(self.tracks_csv)
        with open(self.tracks_csv, "a", newline="") as f:
            w = csv.writer(f)
            if not file_exists:
                w.writerow(["Frame Index", "Track ID", "Linear Velocity",
                            "X Velocity", "Y Velocity", "Angular Velocity"])
            for tid, state in tracks.items():
                w.writerow([frame_index, tid, float(np.linalg.norm(state[2:4])),
                            state[2], state[3], state[1]])

    @staticmethod
    def print_final_track_velocities(tracks: dict[int, np.ndarray]) -> None:
        print("Final Track Velocities:")
        for tid, state in tracks.items():
            mag = float(np.hypot(state[2], state[3]))
            print(f"Track : {tid}")
            print(f"  Final Velocity: vx = {state[2]:.2f}, vy = {state[3]:.2f}")
            print(f"  Magnitude: {mag:.2f}\n")
