"""The port's three flow kernels, held to the JAX package's Pallas kernels.

Here on the CPU each wrapper takes its plain PyTorch version (``*_reference``),
so these tests hold the plain versions to the JAX kernels (run in interpret
mode, as the JAX package's own tests run them).  The CUDA kernels are held to
the same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu.ops import flow_pallas
from datmo_using_optical_flow_tpu.ops import warp_pallas
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.ops import warp
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _planes(shape, seed):
    """Normal-equation planes with the structure of real M (as the JAX tests)."""
    rng = np.random.default_rng(seed)
    r4, r5, r2, r3 = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    r6 = rng.normal(size=shape).astype(np.float32) * 0.3
    return np.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                     r4 * r2 + r6 * r3, r6 * r2 + r5 * r3])


def _smooth_flow(h, w, amp=4.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = amp * np.sin(yy / 23) * np.cos(xx / 31)
    dy = 0.7 * amp * np.cos(yy / 19) * np.sin(xx / 37)
    return dx.astype(np.float32), dy.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("h,w,n,sigma", [
    pytest.param(64, 200, 5, 5.0, id="64-200"),
    pytest.param(37, 131, 5, 5.0, id="37-131"),
    pytest.param(270, 480, 5, 5.0, id="270-480"),
    pytest.param(97, 173, 5, 5.0, id="97-173"),      # the main path's coarsest level
    pytest.param(37, 131, 7, 1.5, id="37-131-n7"),   # the other poly_n
    pytest.param(64, 200, 5, 0.3, id="64-200-s0.3"),  # g's end taps underflow in float32
])
def test_poly_exp_reference_matches_pallas_kernel(h, w, n, sigma):
    """K1: atol 1e-5 relative to the plane scale (the JAX kernel itself differs
    from the jnp path by ~1 ulp of FMA formation)."""
    rng = np.random.default_rng(h)
    img = rng.normal(size=(h, w)).astype(np.float32) * 50 + 100
    want = np.asarray(flow_pallas.poly_exp_pallas(jnp.asarray(img), n, sigma))
    got = fk.poly_exp(_t(img), n, sigma).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    np.testing.assert_array_equal(got, fb.poly_exp(_t(img), n, sigma).numpy())


# K1's tiny form (at most n rows or columns): shapes where XLA's compiled
# poly_exp used to round otherwise than the plain version (5x122 ... 5x5), at
# four sigmas; one row, one column, one pixel and both sides of h = n and
# w = n; and 30 seeded (h, w) with one axis in 1..n+1, the other in 1..300.
_TINY_TABLE = ((5, 122, 5), (5, 124, 5), (4, 200, 5), (122, 5, 5), (200, 3, 5), (7, 300, 7),
               (5, 5, 5))
_TINY_EDGES = ((1, 150, 5), (150, 1, 5), (1, 1, 5), (1, 200, 7), (200, 1, 7), (1, 1, 7),
               (5, 150, 5), (6, 150, 5), (150, 5, 5), (150, 6, 5),
               (7, 150, 7), (8, 150, 7), (150, 7, 7), (150, 8, 7))


def _tiny_sweep(count=30, seed=14):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.choice([5, 7]))
        s = float(rng.choice([0.3, 1.1, 1.5, 5.0]))
        small, large = int(rng.integers(1, n + 2)), int(rng.integers(1, 301))
        out.append((small, large, n, s) if rng.random() < 0.5 else (large, small, n, s))
    return out


# Where the tiny form does not yet round as XLA does (ROADMAP Queue 3 item 8,
# measured): 2 <= w < n below more than n rows, both axes at most n (but one
# pixel), w = n at sigma 0.3, and 7 rows at n = 7 with 6 columns past the
# last vector of 8.
_TINY_OPEN = {(122, 5, 5, 0.3), (200, 3, 5, 0.3), (200, 3, 5, 1.1), (200, 3, 5, 1.5),
              (200, 3, 5, 5.0), (5, 5, 5, 1.1), (5, 5, 5, 1.5), (5, 5, 5, 5.0), (7, 150, 7, 5.0),
              (109, 4, 5, 5.0), (193, 3, 5, 5.0), (69, 2, 7, 1.5), (50, 5, 7, 5.0),
              (246, 2, 7, 0.3), (197, 2, 7, 1.1), (299, 3, 7, 1.5), (175, 6, 7, 1.1),
              (241, 4, 7, 0.3), (17, 3, 5, 0.3), (217, 2, 5, 1.1)}
_TINY_CASES = [
    pytest.param(h, w, n, s, id=f"tiny-{h}-{w}-n{n}-s{s}", marks=[pytest.mark.xfail(
        strict=True, reason="tiny form not yet XLA's here (ROADMAP Queue 3 item 8)")]
        if (h, w, n, s) in _TINY_OPEN else [])
    for h, w, n, s in ([(h, w, n, s) for h, w, n in _TINY_TABLE for s in (0.3, 1.1, 1.5, 5.0)]
                       + [(h, w, n, s) for h, w, n in _TINY_EDGES
                          for s in ((5.0, 1.1) if n == 5 else (1.5, 5.0))]
                       + _tiny_sweep())]


@pytest.mark.parametrize("h,w,n,sigma", [
    pytest.param(200, 200, 5, 1.1, id="200-200"),        # pipeline A's level 0
    pytest.param(128, 160, 5, 5.0, id="128-160"),        # Tier-1's sharded flow
    pytest.param(98, 173, 5, 5.0, id="98-173"),          # the 1088x1920 pyramid's levels
    pytest.param(326, 576, 5, 5.0, id="326-576"),
    pytest.param(200, 200, 7, 1.5, id="200-200-n7"),
    pytest.param(98, 173, 5, 0.3, id="98-173-s0.3"),     # g's end taps underflow
    # narrow levels (w + n < 128): A's 60x60, 720p's 65x115, 4K's 59x104, and
    # both sides of the boundary, at the pipelines' sigma 5.0 and 1.1; the
    # rule is the width alone, at any height (200x50 to a tall 1088x120)
    *(pytest.param(h, w, 5, s, id=f"{h}-{w}-s{s}")
      for h, w in ((60, 60), (65, 115), (59, 104), (64, 122), (64, 123), (64, 124),
                   (100, 100), (128, 79), (79, 128), (200, 50), (125, 80), (99, 101),
                   (101, 99), (1088, 120))
      for s in (5.0, 1.1)),
    pytest.param(64, 120, 7, 1.5, id="64-120-n7"),       # n = 7: narrow up to w = 120
    pytest.param(64, 121, 7, 1.5, id="64-121-n7"),
    pytest.param(60, 60, 5, 0.3, id="60-60-s0.3"),       # the runtime-n kernel's taps
    *_TINY_CASES,
])
def test_poly_exp_reference_bit_equal_to_jitted_jax(h, w, n, sigma):
    """K1's plain version rounds as the JAX package's ``poly_exp`` compiled
    for the CPU: each correlation a chain of contracted multiply-adds, the
    x^2 plane's shared products separately rounded.  (A few ulps here moved
    the packed warp's int8 corners by a step.)  Where ``w + n < 128`` XLA
    fuses the vertical pass into the planes' fusion and the y^2 plane takes
    its narrow form (``poly_exp_narrow``).  At most ``n`` rows or columns K1
    takes its tiny form (``ops/poly_tiny``): the Motivation shapes of the
    repair at four sigmas, one row, one column, one pixel, both sides of
    ``h = n`` and ``w = n``, and a seeded sweep of such shapes."""
    rng = np.random.default_rng(h + w)
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jfb.poly_exp(x, n, sigma))(jnp.asarray(img)))
    np.testing.assert_array_equal(fk.poly_exp_reference(_t(img), n, sigma).numpy(), want)


@pytest.mark.parametrize("n,sigma,compiled", [(5, 5.0, True), (7, 1.5, True), (5, 1.1, True),
                                              (5, 0.3, False), (7, 0.3, False)])
def test_poly_exp_instance_follows_the_structural_zero_pattern(n, sigma, compiled):
    """The configurations' taps (5, 5.0), (7, 1.5) and (5, 1.1) have the
    structural zero pattern (xg and xxg zero only at the centre), so the card
    runs K1's compile-time instance; sigma 0.3 underflows the end taps of g
    in float32 and takes the runtime-n kernel."""
    g, xg, xxg, _ = fk._poly_taps(n, sigma)
    assert fk.poly_exp_compiled(n, sigma) == compiled
    assert xg[n] == 0.0 and xxg[n] == 0.0
    assert bool((g != 0).all()) == compiled


@pytest.mark.parametrize("h,w,win,gaussian", [(17, 33, 7, False), (64, 128, 15, False),
                                              (30, 41, 31, False), (100, 130, 15, True),
                                              (17, 33, 7, True), (97, 173, 15, False)])
def test_blur_solve_reference_matches_pallas_kernel(h, w, win, gaussian):
    """K2, box and Gaussian windows: atol 1e-4 (float regrouping)."""
    M = _planes((h, w), seed=h + win)
    edx, edy = flow_pallas.blur_solve(jnp.asarray(M), win, gaussian)
    gdx, gdy = fk.blur_solve(_t(M), win, gaussian)
    np.testing.assert_allclose(gdx.numpy(), np.asarray(edx), atol=1e-4)
    np.testing.assert_allclose(gdy.numpy(), np.asarray(edy), atol=1e-4)


@pytest.mark.parametrize("h,w,win,gaussian", [(160, 384, 15, False), (140, 300, 15, False),
                                              (132, 384, 7, True), (130, 384, 15, False)])
def test_fused_iteration_reference_matches_pallas_kernel(h, w, win, gaussian):
    """K3 at atol 2e-4, including h % 32 < win//2 (h = 130), where the TPU
    kernel repairs its last strip's edge replication."""
    rng = np.random.default_rng(h)
    R0 = rng.normal(size=(5, h, w)).astype(np.float32)
    R1 = rng.normal(size=(5, h, w)).astype(np.float32)
    dx, dy = _smooth_flow(h, w)
    assert warp.eligible(h, w) and bool(warp_pallas.flow_in_range(jnp.asarray(dx), jnp.asarray(dy)))
    edx, edy = flow_pallas.fused_iteration(
        jnp.asarray(R0), warp_pallas._pad_r1(jnp.asarray(R1), s=flow_pallas.FS),
        jnp.asarray(dx), jnp.asarray(dy), win, gaussian)
    gdx, gdy = fk.fused_iteration(_t(R0), _t(R1), _t(dx), _t(dy), win, gaussian)
    np.testing.assert_allclose(gdx.numpy(), np.asarray(edx), atol=2e-4)
    np.testing.assert_allclose(gdy.numpy(), np.asarray(edy), atol=2e-4)


@pytest.mark.parametrize("h,w", [(97, 173), (37, 53), (2, 3)])
def test_pack_corner_pairs_bit_equal(h, w):
    rng = np.random.default_rng(w)
    R1 = rng.normal(size=(5, h, w)).astype(np.float32) * np.float32(30.0)
    R1[2, 0, 0] = 0.0
    jtable, jscale = jfb.pack_corner_pairs(jnp.asarray(R1))
    table, scale = fb.pack_corner_pairs(_t(R1))
    assert table.dtype == torch.int32 and table.shape == (h * w, 7)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable).view(np.int32))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_packed_update_matrices_matches_jax():
    """The quantized warp of the small levels (update_matrices with the packed
    table) is the JAX package's, bit for bit."""
    rng = np.random.default_rng(3)
    h, w = 97, 173
    R0, R1 = (rng.normal(size=(5, h, w)).astype(np.float32) for _ in range(2))
    dx, dy = (rng.normal(size=(h, w)).astype(np.float32) * 3 for _ in range(2))
    want = jfb.update_matrices(*map(jnp.asarray, (R0, R1, dx, dy)),
                               jfb.pack_corner_pairs(jnp.asarray(R1)))
    got = fb.update_matrices(*map(_t, (R0, R1, dx, dy)), fb.pack_corner_pairs(_t(R1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_out_of_window_flow_takes_the_exact_warp():
    """Flow beyond the JAX TPU kernel's warp window: JAX falls back to the
    packed int16/int8 warp, the port keeps the exact fused iteration, i.e. the
    exact update_matrices -> box window -> solve of the JAX jnp path."""
    h, w = 160, 384
    rng = np.random.default_rng(7)
    R0, R1 = (rng.normal(size=(5, h, w)).astype(np.float32) for _ in range(2))
    dx = np.full((h, w), 100.0, np.float32)  # far past the window's floor(dx) <= 62
    dy = np.zeros((h, w), np.float32)
    assert not bool(warp_pallas.flow_in_range(jnp.asarray(dx), jnp.asarray(dy)))
    assert not bool(warp.flow_in_range(_t(dx), _t(dy)))
    gdx, gdy = fb.farneback_level(*map(_t, (R0, R1, dx, dy)), winsize=15, iterations=1)
    M = jfb.update_matrices(*map(jnp.asarray, (R0, R1, dx, dy)))
    edx, edy = jfb.solve_flow(jfb.box_blur5(M, 15))
    np.testing.assert_allclose(gdx.numpy(), np.asarray(edx), atol=1e-4)
    np.testing.assert_allclose(gdy.numpy(), np.asarray(edy), atol=1e-4)
    # ... and the JAX kernel path's quantized fallback is a different result
    qdx, _ = flow_pallas.farneback_level(*map(jnp.asarray, (R0, R1, dx, dy)),
                                         winsize=15, iterations=1)
    assert np.abs(gdx.numpy() - np.asarray(qdx)).max() > 1e-4


def test_flow_in_range_matches_jax():
    h, w = 64, 300
    for dxv, dyv in ((62.5, 0.0), (63.0, 0.0), (-64.0, 0.0), (-64.5, 0.0),
                     (0.0, 14.9), (0.0, 15.0), (0.0, -16.0), (0.0, -16.2)):
        dx = np.full((h, w), dxv, np.float32)
        dy = np.full((h, w), dyv, np.float32)
        assert bool(warp.flow_in_range(_t(dx), _t(dy))) == \
            bool(warp_pallas.flow_in_range(jnp.asarray(dx), jnp.asarray(dy))), (dxv, dyv)
    for h, w in ((128, 256), (127, 256), (128, 255), (1080, 1920), (97, 173)):
        assert warp.eligible(h, w) == warp_pallas.eligible(h, w)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counters stay put, and a
    device with neither a kernel nor a plain version raises."""
    fk.reset_launches()
    img = torch.rand(40, 48)
    fk.poly_exp(img, 5, 5.0)
    fk.blur_solve(torch.rand(5, 40, 48), 15)
    fk.fused_iteration(torch.rand(5, 40, 48), torch.rand(5, 40, 48), torch.zeros(40, 48),
                       torch.zeros(40, 48), 15)
    fk.warp_matrices(torch.rand(5, 40, 48), torch.rand(5, 40, 48), torch.zeros(40, 48),
                     torch.zeros(40, 48))
    assert fk.LAUNCHES == {"poly_exp": 0, "blur_solve": 0, "fused_iteration": 0,
                           "warp_matrices": 0}
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fk.poly_exp(torch.empty(40, 48, device="meta"), 5, 5.0)
    with pytest.raises(ValueError, match="contiguous"):
        fk.poly_exp(torch.rand(48, 40).T, 5, 5.0)
    with pytest.raises(TypeError, match="float32"):
        fk.blur_solve(torch.rand(5, 40, 48, dtype=torch.float64), 15)
    with pytest.raises(ValueError, match="winsize"):
        fk.blur_solve(torch.rand(5, 40, 48), 65)
