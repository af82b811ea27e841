"""Frame sources: fixed-capacity padded point buffers from PCD files.

A copy of ``datmo_using_optical_flow_tpu.io.frames`` (the host side is numpy
in both packages).  The host pads each ``(N, 3)`` cloud to ``(capacity, 3)``
with a validity mask, so every frame has one shape, and a pool of decode
threads reads the next frames while the device works on the current one.
Optionally the points travel as int16 fixed point (``Q16_SCALE`` = 2^-10 m
per step, half the host-to-device bytes), dequantised exactly on the device
by :func:`dequantize_points_q16`.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Iterator, Sequence

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.io.pcd import read_pcd

Q16_SCALE = np.float32(1.0 / 1024.0)
_Q16_SENTINEL = np.int16(32767)  # dequantises to ~32 m: outside every ROI
_WORKERS, _PREFETCH = 2, 4  # DiskFrameSource's decode threads and frames ahead


def pad_points(points: np.ndarray, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad an (N, 3) array to ``(capacity, 3)`` float32; returns (padded,
    validity mask).

    N > capacity truncates with a warning.  Padding rows hold a far-away
    sentinel (1e9) so they fall outside every ROI."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n > capacity:
        warnings.warn(f"pad_points: truncating {n} points to capacity {capacity}")
        points = points[:capacity]
        n = capacity
    out = np.full((capacity, 3), 1e9, dtype=np.float32)
    out[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask


def quantize_points_q16(points: np.ndarray) -> np.ndarray:
    """(N, 3) float metres -> int16 fixed point at 2^-10 m per step (clipped);
    float32 arithmetic on the host, within half a step of the float64 answer."""
    q = np.rint(np.asarray(points, np.float32) * np.float32(1.0 / Q16_SCALE))
    return np.clip(q, -32768, 32767).astype(np.int16)


def dequantize_points_q16(q: torch.Tensor) -> torch.Tensor:
    """int16 fixed point -> float32 metres, exact (a power-of-two scale)."""
    return q.to(torch.float32) * float(Q16_SCALE)


def pad_points_q16(points: np.ndarray, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """:func:`pad_points` with an int16 fixed-point payload."""
    points = quantize_points_q16(points)
    n = points.shape[0]
    if n > capacity:
        warnings.warn(f"pad_points_q16: truncating {n} points to capacity {capacity}")
        points = points[:capacity]
        n = capacity
    out = np.full((capacity, 3), _Q16_SENTINEL, dtype=np.int16)
    out[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask


def natsort_key(path: str):
    """Natural-order sort key (the reference sorts with ``natsorted``)."""
    return [int(tok) if tok.isdigit() else tok
            for tok in re.split(r"(\d+)", os.path.basename(path))]


def pcd_files_in(folder: str) -> list[str]:
    """The folder's ``.pcd`` files in natural order."""
    return sorted((os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".pcd")),
                  key=natsort_key)


class DiskFrameSource:
    """Iterates PCD frames from disk as padded buffers, in order.

    Two threads decode up to four frames ahead (the native decoder releases
    the GIL in its ctypes call).  A frame that fails to decode is delivered
    empty, so the stream goes on (the reference skips a bad pair,
    ``Optical_flow/main.py:635-637``).
    """

    def __init__(self, pcd_files: Sequence[str] | None = None, folder: str | None = None,
                 capacity: int = 65536, quantize_q16: bool = False):
        if pcd_files is None:
            if folder is None:
                raise ValueError("provide pcd_files or folder")
            pcd_files = pcd_files_in(folder)
        self.pcd_files = list(pcd_files)
        self.capacity = capacity
        self.quantize_q16 = quantize_q16

    def __len__(self) -> int:
        return len(self.pcd_files)

    def load(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        """One frame as ``(points, mask)``, padded to ``capacity`` (q16 when
        ``quantize_q16``); a file that fails to decode is an empty frame."""
        try:
            points = read_pcd(path, dtype=np.float32)
        except Exception as e:  # noqa: BLE001  (any decode failure: an empty frame)
            print(f"Error decoding {path}: {e}")
            points = np.zeros((0, 3), np.float32)
        if self.quantize_q16:
            return pad_points_q16(points, self.capacity)
        return pad_points(points, self.capacity)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        n = len(self.pcd_files)
        if n == 0:
            return
        with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
            futures = {i: pool.submit(self.load, self.pcd_files[i])
                       for i in range(min(_PREFETCH, n))}
            for i in range(n):
                item = futures.pop(i).result()
                nxt = i + _PREFETCH
                if nxt < n:
                    futures[nxt] = pool.submit(self.load, self.pcd_files[nxt])
                yield item
