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


# JAX's compiled functions are the reference: XLA contracts each product of
# the blur's and the resize's into the add that takes it (eager JAX, like
# PyTorch, rounds both), and every JAX step runs them jitted.
_UPSAMPLE = float(np.float32(1 / 0.3))


_RESIZE_CASES = [
    ((2, 33, 40), (100, 120), 1.0), ((5, 33), (12, 10), 1.0), ((97, 173), (324, 576), 1.0),
    ((256, 320), (77, 96), 1.0), ((200, 200), (60, 60), 1.0), ((120, 100), (36, 30), 1.0),
    ((7, 150), (2, 45), 1.0), ((150, 7), (45, 2), 1.0), ((1, 64), (1, 19), 1.0),
    ((64, 1), (19, 1), 1.0), ((60, 60), (18, 18), 1.0),
    # the flow's 2-plane upsample between levels, times 1 / pyr_scale
    ((2, 97, 173), (324, 576), _UPSAMPLE), ((2, 60, 60), (200, 200), _UPSAMPLE),
    ((2, 18, 31), (60, 104), _UPSAMPLE), ((2, 65, 115), (216, 384), _UPSAMPLE),
    ((2, 59, 104), (196, 346), _UPSAMPLE)]


@pytest.mark.parametrize("shape,out,scale", _RESIZE_CASES,
                         ids=[f"shape{i}-out{i}" for i in range(len(_RESIZE_CASES))])
def test_resize_bilinear_bit_equal(shape, out, scale):
    """``resize_bilinear(x, h, w, scale)`` equals the jitted JAX
    ``resize_bilinear(x, h, w) * scale``, narrow and tiny shapes included."""
    x = np.random.default_rng(len(shape) + out[0]).normal(size=shape).astype(np.float32)
    s32 = np.float32(scale)
    want = np.asarray(jax.jit(lambda a: jfb.resize_bilinear(a, *out) * s32)(jnp.asarray(x)))
    got = fb.resize_bilinear(torch.as_tensor(x), *out, scale)
    np.testing.assert_array_equal(got.numpy(), want)


_BLUR_CASES = [
    ((64, 80), 3, 0.0), ((64, 80), 7, 1.1), ((64, 80), 25, 5.06), ((200, 200), 7, 1.1667),
    ((200, 200), 25, 5.0556), ((256, 320), 91, 18.019),   # the 4K pyramid's last level
    ((40, 60), 25, 5.06), ((120, 100), 7, 1.17), ((3, 200), 25, 5.06), ((7, 150), 7, 1.17),
    ((150, 7), 25, 5.06), ((5, 5), 7, 1.1), ((1, 64), 7, 1.17), ((64, 1), 7, 1.17),
    ((1, 300), 91, 18.019), ((300, 1), 25, 5.06), ((1, 1), 7, 1.1)]


@pytest.mark.parametrize("shape,ksize,sigma", _BLUR_CASES, ids=[
    f"{k}-{s}" if shape == (64, 80) else f"{shape[0]}x{shape[1]}-{k}-{s}"
    for shape, k, s in _BLUR_CASES])
def test_gaussian_blur_bit_equal(shape, ksize, sigma):
    """``gaussian_blur`` equals the jitted JAX function, where the radius
    reaches past an axis (reflect-101 repeated, as ``jnp.pad``) and on an
    axis of one value (XLA shares the products of equal taps) too."""
    x = np.random.default_rng(ksize).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jfb.gaussian_blur(a, ksize, sigma))(jnp.asarray(x)))
    np.testing.assert_array_equal(fb.gaussian_blur(torch.as_tensor(x), ksize, sigma).numpy(),
                                  want)


@pytest.mark.parametrize("h,w", [(200, 200), (256, 320)])
@pytest.mark.parametrize("kind", ["frames", "integers"])
def test_build_pyramid_bit_equal_to_jitted_jax(h, w, kind):
    """Every level of the port's pyramid equals the jitted JAX
    ``build_pyramid(..., use_pallas=False)``: the level images (blur and
    resize, ``level_image``) and K1's plain version.  The 1080x1920 pyramid:
    ``tests/test_torch_pyramid_1080p.py`` (slow)."""
    im = (make_frames(1, h, w, seed=3)[0] if kind == "frames" else
          np.random.default_rng(h).integers(1, 255, (h, w))).astype(np.float32)
    build = jax.jit(lambda a: jfb.build_pyramid(a, use_pallas=False, **PYR))
    want = [np.asarray(p) for p in build(jnp.asarray(im))]
    got = fb.build_pyramid(torch.as_tensor(im), **PYR)
    assert [tuple(g.shape) for g in got] == [p.shape for p in want]
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), e)


def test_build_pyramid_matches_jax(frames, jax_pyramids):
    """Against the pyramids of ``bench.py``'s kernel path (``use_pallas=True``),
    within 1e-5 of each level's scale, not bit for bit: levels of at least
    256x256 go through JAX's Pallas strip kernel ``poly_exp_pallas``, whose
    planes differ from the compiled jnp ``poly_exp`` (which the port follows,
    level images included: the test above) by ~1 ulp, the kernel's own
    fmas."""
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


@pytest.mark.parametrize("h,w", [(5, 122), (122, 5), (1, 64), (64, 1)])
def test_tiny_image_flow_matches_jax_exact_path(h, w):
    """At most poly_n rows or columns (one pyramid level) K1 takes its tiny
    form: the port's flow against the JAX package's exact jnp path on a pair
    cut from two frames, flow atol 1e-4 px as the exact-warp test above."""
    a, b = make_frames(2, 160, 160, seed=h)[:, 20:20 + h, 20:20 + w].astype(np.float32)
    want = np.asarray(jfb.farneback_flow(jnp.asarray(a), jnp.asarray(b)))
    got = fb.farneback_flow(torch.as_tensor(a), torch.as_tensor(b), fast_warp=False)
    assert got.shape == (h, w, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the pair moves (a single row or column: its 2x2 solves are singular,
    # and both flows are ~0)
    assert np.abs(want).max() > (0.01 if min(h, w) > 1 else 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_identical_noise_flow_follows_jitted_jax_pieces(seed):
    """Two identical uniform-noise 200x200 frames (near-singular normal
    equations): the port's exact-warp flow within 1e-6 px of JAX's jitted
    ``flow_from_pyramids(use_pallas=False, fast_warp=False)`` on its jitted
    ``build_pyramid``.  JAX's whole jitted ``farneback_flow`` parts from
    those pieces by ~0.1 px on these frames: XLA compiles the refinement
    otherwise when it shares one program with the pyramid."""
    a = np.random.default_rng(seed).uniform(0, 255, (200, 200)).astype(np.float32)
    pyr = jax.jit(lambda im: jfb.build_pyramid(im, use_pallas=False, **PYR))(jnp.asarray(a))
    flow = jax.jit(lambda p1, p2: jfb.flow_from_pyramids(
        p1, p2, 0.3, 15, 5, use_pallas=False, fast_warp=False))
    want = np.asarray(flow(pyr, pyr))
    got = fb.farneback_flow(torch.as_tensor(a), torch.as_tensor(a), fast_warp=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
