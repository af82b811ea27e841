"""Synthetic BEV frames for pipeline A (numpy only).

A copy of ``make_frames`` of the JAX package's benchmark script
(``bench.py``), the frames of pipeline A's 1080p workload, kept here so that
the port and its smoke run import nothing of the JAX side;
``tests/test_torch_sim.py`` holds the copy equal to the original, bit for bit.
"""

from __future__ import annotations

import numpy as np


def make_frames(n: int, h: int, w: int, seed: int = 0, n_objects: int = 6) -> np.ndarray:
    """(n, h, w) uint8 frames: a smooth textured background and ``n_objects``
    textured squares (60-139 px) moving at up to ~6 px per frame, plus noise."""
    rng = np.random.default_rng(seed)

    def smooth_noise(shape, scale=8):
        small = rng.uniform(0, 255, (shape[0] // scale + 2, shape[1] // scale + 2))
        ys = np.linspace(0, small.shape[0] - 1.001, shape[0])
        xs = np.linspace(0, small.shape[1] - 1.001, shape[1])
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        a = small[y0][:, x0]
        b = small[y0][:, x0 + 1]
        c = small[y0 + 1][:, x0]
        d = small[y0 + 1][:, x0 + 1]
        return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy

    base = smooth_noise((h, w)) * 0.4
    objs = []
    for _ in range(n_objects):
        size = int(rng.integers(60, 140))
        objs.append({
            "tex": smooth_noise((size, size), scale=4) * 0.8 + 40,
            "pos": rng.uniform([0.15 * h, 0.15 * w], [0.7 * h, 0.7 * w]),
            "vel": rng.uniform(-6, 6, size=2),
            "size": size,
        })
    frames = np.empty((n, h, w), np.uint8)
    for t in range(n):
        img = base.copy()
        for o in objs:
            cy, cx = (o["pos"] + o["vel"] * t).astype(int)
            s = o["size"]
            y0, x0 = np.clip(cy, 0, h - s), np.clip(cx, 0, w - s)
            img[y0:y0 + s, x0:x0 + s] = o["tex"]
        img += rng.normal(scale=1.0, size=(h, w))
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames
