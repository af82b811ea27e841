"""The port's copies of the scene and frame generators (``sim/``) against the
originals: ``datmo_using_optical_flow_tpu.sim.synthetic`` and ``bench.py``'s
``make_frames``.  Both are numpy only and must agree bit for bit.
"""

import numpy as np
import pytest

from bench import make_frames as j_make_frames
from datmo_using_optical_flow_tpu.sim import synthetic as jsyn
from datmo_using_optical_flow_tpu_torch.sim import synthetic as tsyn
from datmo_using_optical_flow_tpu_torch.sim.frames import make_frames as t_make_frames
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _scene(mod, **kw):
    box = mod.BoxTarget
    return mod.SyntheticScene(
        ground_points=600, ground_extent=12.0,
        static_boxes=(box(center0=(-4.0, 3.0, 1.0), velocity=(0, 0), points_per_frame=150),),
        targets=(box(center0=(3.0, -2.0, 0.75), velocity=(1.5, 0.8), points_per_frame=120),
                 box(center0=(-3.0, 2.5, 0.75), velocity=(-1.0, -1.2), size=(3.0, 1.6, 1.4),
                     points_per_frame=100, accel=(0.3, -0.2), spawn_frame=1),
                 box(center0=(0.0, 5.0, 0.75), velocity=(0.5, -1.5), points_per_frame=90,
                     turn_rate=0.4, despawn_frame=2)),
        seed=11, **kw)


@pytest.mark.parametrize("kw", [{}, {"clutter_blobs": 3, "occlusion": True}])
def test_synthetic_frame_copy_is_bit_equal(kw):
    for i in range(3):
        for dt in (1.0, 0.1):
            got = tsyn.synthetic_frame(_scene(tsyn, **kw), i, dt)
            want = jsyn.synthetic_frame(_scene(jsyn, **kw), i, dt)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_scene_dataclasses_match():
    for name in ("BoxTarget", "SyntheticScene"):
        t, j = getattr(tsyn, name)(), getattr(jsyn, name)()
        assert [f for f in vars(t)] == [f for f in vars(j)]
        assert {k: str(v) for k, v in vars(t).items()} == {k: str(v) for k, v in vars(j).items()}


def test_make_frames_copy_is_bit_equal():
    # the objects are 60-139 px squares, so at 64x96 only the background fits
    for args in ((3, 64, 96, 0, 0), (3, 160, 192), (2, 256, 320, 5)):
        got, want = t_make_frames(*args), j_make_frames(*args)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
