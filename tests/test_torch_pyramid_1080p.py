"""The port's 1080x1920 pyramid bit-equal to the JAX package's jitted
``build_pyramid(..., use_pallas=False)`` at every level (slow: ~1 min on the
CPU, most of it JAX's compile and the port's float64 fma form)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_frames
from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PYR = dict(pyr_scale=0.3, levels=5, poly_n=5, poly_sigma=5.0)


@pytest.mark.slow
def test_build_pyramid_1080p_bit_equal_to_jitted_jax():
    im = make_frames(1, 1080, 1920, seed=0)[0].astype(np.float32)
    build = jax.jit(lambda a: jfb.build_pyramid(a, use_pallas=False, **PYR))
    want = [np.asarray(p) for p in build(jnp.asarray(im))]
    got = fb.build_pyramid(torch.as_tensor(im), **PYR)
    assert [tuple(g.shape) for g in got] == [(5, 97, 173), (5, 324, 576), (5, 1080, 1920)]
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), e)
