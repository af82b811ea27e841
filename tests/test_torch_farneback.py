"""The port's Farnebäck flow against the JAX package's, on the same inputs.

The JAX side runs the kernel path of ``bench.py`` (``use_pallas=True,
fast_warp=True``; Pallas in interpret mode on the CPU).  At 256x320 the pyramid
has two levels, 256x320 (polynomial-expansion and fused-iteration kernels) and
77x96 (packed warp + window/solve kernel), so all three kernels' plain versions
run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_frames
from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu.ops import warp_pallas
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import warp
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 256, 320
PYR = dict(pyr_scale=0.3, levels=5, poly_n=5, poly_sigma=5.0)


@pytest.fixture(scope="module")
def frames():
    return make_frames(2, H, W, seed=3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_pyramids(frames):
    build = jax.jit(lambda im: jfb.build_pyramid(im, use_pallas=True, **PYR))
    return [jax.device_get(build(jnp.asarray(f))) for f in frames]


@pytest.mark.parametrize("shape,out", [((2, 33, 40), (100, 120)), ((5, 33), (12, 10)),
                                       ((97, 173), (324, 576)), ((256, 320), (77, 96))])
def test_resize_bilinear_bit_equal(shape, out):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    want = np.asarray(jfb.resize_bilinear(jnp.asarray(x), *out))
    np.testing.assert_array_equal(fb.resize_bilinear(torch.as_tensor(x), *out).numpy(), want)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (7, 1.1), (25, 5.06)])
def test_gaussian_blur_bit_equal(ksize, sigma):
    x = np.random.default_rng(ksize).uniform(0, 255, (64, 80)).astype(np.float32)
    want = np.asarray(jfb.gaussian_blur(jnp.asarray(x), ksize, sigma))
    np.testing.assert_array_equal(fb.gaussian_blur(torch.as_tensor(x), ksize, sigma).numpy(),
                                  want)


def test_build_pyramid_matches_jax(frames, jax_pyramids):
    got = fb.build_pyramid(torch.tensor(frames[0]), **PYR)
    want = jax_pyramids[0]
    assert [tuple(g.shape) for g in got] == [(5, 77, 96), (5, 256, 320)]
    for g, e in zip(got, want):
        scale = np.abs(e).max()
        assert np.abs(g.numpy() - e).max() <= 1e-5 * scale


def test_flow_from_pyramids_matches_jax(jax_pyramids):
    """Same pyramids into both refinements; flow atol 1e-4 px.  The eligible
    level's flows stay inside the JAX kernel's warp window (else JAX would have
    compared its quantized fallback against the port's exact warp)."""
    p1, p2 = jax_pyramids
    args = dict(pyr_scale=0.3, winsize=15, iterations=5)
    flow_j = jax.jit(lambda a, b: jfb.flow_from_pyramids(a, b, use_pallas=True,
                                                         fast_warp=True, **args))
    want = np.asarray(flow_j(tuple(map(jnp.asarray, p1)), tuple(map(jnp.asarray, p2))))
    got = fb.flow_from_pyramids(tuple(map(torch.tensor, p1)),
                                tuple(map(torch.tensor, p2)), **args)
    assert got.shape == (H, W, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    # the eligible level's flow in (the upsampled coarse flow) and out
    coarse = fb.flow_from_pyramids((torch.tensor(p1[0]),), (torch.tensor(p2[0]),), **args)
    flow_in = fb.resize_bilinear(torch.movedim(coarse, -1, 0), H, W) * float(np.float32(1 / 0.3))
    assert warp.eligible(H, W)
    for dx, dy in ((flow_in[0], flow_in[1]), (got[..., 0], got[..., 1])):
        assert bool(warp_pallas.flow_in_range(jnp.asarray(dx.numpy()), jnp.asarray(dy.numpy())))
    assert np.abs(want).max() > 1.0  # the scene moves


def test_farneback_flow_pair_matches_stream_pyramids(frames):
    """farneback_flow (both pyramids built inside) equals the refinement over
    separately built pyramids."""
    a, b = (torch.as_tensor(f) for f in frames)
    flow = fb.farneback_flow(a, b)
    pyrs = [fb.build_pyramid(x, **PYR) for x in (a, b)]
    np.testing.assert_array_equal(
        flow.numpy(), fb.flow_from_pyramids(*pyrs, 0.3, 15, 5).numpy())


def test_exact_warp_option_matches_jax_exact_path(frames):
    """fast_warp=False warps every level exactly: the JAX package's exact jnp
    path (use_pallas=False, fast_warp=False), flow atol 1e-4 px."""
    a, b = frames
    want = np.asarray(jfb.farneback_flow(jnp.asarray(a), jnp.asarray(b)))
    got = fb.farneback_flow(torch.as_tensor(a), torch.as_tensor(b), fast_warp=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# Gaussian window: XLA's CPU compile contracts each tap's multiply-add into an
# FMA (its eager ops, like PyTorch's, round both), so the 5 jitted iterations
# drift up to ~3e-4 px at ill-conditioned pixels; the box's unit taps do not.
@pytest.mark.parametrize("flags,atol", [(4, 1e-4), (4 | 256, 5e-4)])
def test_initial_flow_and_gaussian_flags_match_jax(flags, atol):
    """cv2 flags OPTFLOW_USE_INITIAL_FLOW (4) and OPTFLOW_FARNEBACK_GAUSSIAN
    (256) through the whole flow, on a one-level 64x80 pyramid (packed warp
    and the window/solve kernel)."""
    from datmo_using_optical_flow_tpu.config import FarnebackConfig as JFarneback
    from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig

    rng = np.random.default_rng(flags)
    a, b = make_frames(2, 160, 160, seed=flags)[:, 40:104, 30:110].astype(np.float32)
    flow0 = rng.normal(scale=0.5, size=(64, 80, 2)).astype(np.float32)
    want = np.asarray(jfb.farneback_flow(jnp.asarray(a), jnp.asarray(b), JFarneback(flags=flags),
                                         use_pallas=True, fast_warp=True,
                                         flow0=jnp.asarray(flow0)))
    got = fb.farneback_flow(torch.as_tensor(a), torch.as_tensor(b),
                            FarnebackConfig(flags=flags), flow0=torch.as_tensor(flow0))
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    with pytest.raises(ValueError, match="flow0"):
        fb.farneback_flow(torch.as_tensor(a), torch.as_tensor(b), FarnebackConfig(flags=flags))
