"""The port's Farnebäck flow, through its documented drop-in for
``cv2.calcOpticalFlowFarneback`` (``compat.compute_velocity_vectors``, exact
warp on every level, ``device="cpu"``: the kernels' plain versions), against
cv2 on ``bench.py``-textured moving frames (``sim/frames.make_frames``), with
the JAX package's budget (``tests/test_flow_pallas.py``): a worst-case
end-point error of at most 0.1 px.

x and y ranges of one metre per pixel make the velocities the flow in px.
The reference's 200x200 shape (two levels, 200x200 and 60x60: K1 and K2)
runs in Tier-1; 1080x1920 (three levels: K1, K3 on the two large ones, K2)
is marked slow.
"""

import cv2
import numpy as np
import pytest

from datmo_using_optical_flow_tpu_torch import compat
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

EPE_BUDGET = 0.1  # px, worst case


def _epe(h: int, w: int, seed: int) -> np.ndarray:
    img1, img2 = (f.astype(np.float32) for f in make_frames(2, h, w, seed=seed, n_objects=3))
    vx, vy, _ = compat.compute_velocity_vectors(img1, img2, (0, w), (0, h), device="cpu")
    theirs = cv2.calcOpticalFlowFarneback(img1, img2, None, 0.3, 5, 15, 5, 5, 5, 0)
    assert np.abs(theirs).max() > 1.0  # the scene moves
    return np.hypot(vx - theirs[..., 0], vy - theirs[..., 1])


@pytest.mark.parametrize("seed", [5, 6])
def test_epe_against_cv2_at_200x200(seed):
    epe = _epe(200, 200, seed)
    print(f"200x200 seed {seed}: worst-case EPE {epe.max():.3e} px, "
          f"99th percentile {np.percentile(epe, 99):.2e}")
    assert epe.max() <= EPE_BUDGET


@pytest.mark.slow
def test_epe_against_cv2_at_1080x1920():
    epe = _epe(1080, 1920, 5)
    print(f"1080x1920: worst-case EPE {epe.max():.3e} px, "
          f"99th percentile {np.percentile(epe, 99):.2e}")
    assert epe.max() <= EPE_BUDGET
