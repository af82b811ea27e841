"""The port's three flow kernels, held to the JAX package's Pallas kernels.

Here on the CPU each wrapper takes its plain PyTorch version (``*_reference``),
so these tests hold the plain versions to the JAX kernels (run in interpret
mode, as the JAX package's own tests run them).  The CUDA kernels are held to
the same plain versions on the card by ``chip_smoke.py``.
"""

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
