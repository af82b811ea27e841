"""The port's flow kernels, held to the JAX package's Pallas kernels and to
its jitted jnp functions.

Here on the CPU each wrapper takes its plain PyTorch version (``*_reference``),
so these tests hold the plain versions to the JAX kernels (run in interpret
mode, as the JAX package's own tests run them) at a tolerance, and to the
jitted jnp functions (``update_matrices``, ``gauss_blur5``, ``solve_flow``,
the iteration they make) bit for bit: XLA's compiled CPU code contracts their
multiply-adds, and the plain versions round as it does.  The CUDA kernels are
held to the same plain versions on the card by ``chip_smoke.py``.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_frames
from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu.ops import flow_pallas
from datmo_using_optical_flow_tpu.ops import warp_pallas
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from datmo_using_optical_flow_tpu_torch.ops import warp
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from xla_isa import XLA_AVX512, hold_to_recorded


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
# last vector of 8.  JAX's own bits do not move at these 12 shapes.
_TINY_OPEN = {(122, 5, 5, 0.3), (5, 5, 5, 1.1), (5, 5, 5, 1.5), (5, 5, 5, 5.0),
              (109, 4, 5, 5.0), (69, 2, 7, 1.5), (50, 5, 7, 5.0), (246, 2, 7, 0.3),
              (197, 2, 7, 1.1), (175, 6, 7, 1.1), (241, 4, 7, 0.3), (17, 3, 5, 0.3)}
# Item 8's shapes where JAX's own bits move, so that no single answer is
# XLA's (measured, jax 0.9.0 on an AVX-512 host): the jitted ``poly_exp``
# alone parts from the planes of the jitted ``build_pyramid(im, 0.5, 1, n,
# sigma)`` on the same level image, the program JAX's entry points run
# (_PROGRAM_MOVES), and it moves with the host's vector ISA
# (``XLA_FLAGS=--xla_cpu_max_isa=AVX2``, _ISA_MOVES).  Held by the tests of
# that movement below, not by bit-equality.
_PROGRAM_MOVES = ((7, 150, 7, 5.0), (193, 3, 5, 5.0), (200, 3, 5, 1.1), (200, 3, 5, 1.5),
                  (200, 3, 5, 5.0), (217, 2, 5, 1.1), (299, 3, 7, 1.5))
_ISA_MOVES = ((193, 3, 5, 5.0), (200, 3, 5, 0.3), (200, 3, 5, 1.1), (200, 3, 5, 1.5),
              (200, 3, 5, 5.0))
_JAX_MOVES = sorted(set(_PROGRAM_MOVES) | set(_ISA_MOVES))
_TINY_CASES = [
    pytest.param(h, w, n, s, id=f"tiny-{h}-{w}-n{n}-s{s}", marks=[pytest.mark.xfail(
        strict=True, reason="tiny form not yet XLA's here (ROADMAP Queue 3 item 8)")]
        if (h, w, n, s) in _TINY_OPEN else [])
    for h, w, n, s in ([(h, w, n, s) for h, w, n in _TINY_TABLE for s in (0.3, 1.1, 1.5, 5.0)]
                       + [(h, w, n, s) for h, w, n in _TINY_EDGES
                          for s in ((5.0, 1.1) if n == 5 else (1.5, 5.0))]
                       + _tiny_sweep())
    if (h, w, n, s) not in _JAX_MOVES]


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


def _tiny_image(h, w):
    return np.random.default_rng(h + w).uniform(0, 255, size=(h, w)).astype(np.float32)


def _jit_poly_exp(img, n, sigma):
    return np.asarray(jax.jit(lambda x: jfb.poly_exp(x, n, sigma))(jnp.asarray(img)))


def _program_answers(h, w, n, sigma):
    """The level image of ``build_pyramid(im, 0.5, 1, n, sigma)`` (the
    jitted 3-tap pre-blur; no resize at scale 1), the jitted ``poly_exp`` of
    it alone, and the jitted pyramid's planes."""
    img = _tiny_image(h, w)
    level = np.asarray(jax.jit(lambda x: jfb.gaussian_blur(x, 3, 0.0))(jnp.asarray(img)))
    pyramid = jax.jit(lambda x: jfb.build_pyramid(x, 0.5, 1, n, sigma))(jnp.asarray(img))
    return level, _jit_poly_exp(level, n, sigma), np.asarray(pyramid[0])


@pytest.mark.parametrize("h,w,n,sigma", _PROGRAM_MOVES,
                         ids=[f"{h}-{w}-n{n}-s{s}" for h, w, n, s in _PROGRAM_MOVES])
def test_tiny_jitted_poly_exp_moves_with_its_program(h, w, n, sigma):
    """Item 8's shapes where the jitted ``poly_exp`` alone parts from the
    planes of the jitted ``build_pyramid`` on the same level image: XLA's
    rounding there depends on the program ``poly_exp`` is compiled in, so
    neither is the port's target bit for bit.  The port's tiny form stays
    within 1e-5 of the plane scale of both."""
    level, alone, pyramid = _program_answers(h, w, n, sigma)
    assert (alone != pyramid).any()
    got = fk.poly_exp_reference(_t(level), n, sigma).numpy()
    for want in (alone, pyramid):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def avx2_answers(tmp_path_factory):
    """JAX's answers where its bits depend on the vector instructions XLA
    compiles for, compiled for AVX2 in one process of its own
    (``XLA_FLAGS=--xla_cpu_max_isa=AVX2``) on a host where XLA compiles for
    AVX-512 (else skipped: the default build then is not AVX-512's): the
    jitted ``poly_exp`` of _ISA_MOVES' images ("poly-h-w-n-s"), the
    packed warp's cases (``_packed_jax``, "packed-case") and the tiny warps
    of _ISA_WARPS ("warp-...")."""
    if not XLA_AVX512:
        pytest.skip("XLA does not compile for AVX-512 here, so there is no AVX-512 answer "
                    "to compare the AVX2 build with")
    path = tmp_path_factory.mktemp("avx2") / "answers.npz"
    script = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_farneback_kernels as t\n"
        "out = {}\n"
        "for h, w, n, s in t._ISA_MOVES:\n"
        "    out[f'poly-{h}-{w}-{n}-{s}'] = t._jit_poly_exp(t._tiny_image(h, w), n, s)\n"
        "for case in t._PACKED_MOVES:\n"
        "    out[f'packed-{case}'] = t._packed_jax(case)\n"
        "for warp, h, w, flow in t._ISA_WARPS:\n"
        "    out[f'warp-{warp}-{h}x{w}-{flow}'] = t._isa_warp(warp, h, w, flow)[1]\n"
        "np.savez(sys.argv[1], **out)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = f"{os.environ.get('XLA_FLAGS', '')} --xla_cpu_max_isa=AVX2".strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    subprocess.run([sys.executable, "-c", script, str(path)], cwd=repo, env=env, check=True,
                   timeout=600)
    with np.load(path) as answers:
        return {k: answers[k] for k in answers.files}


@pytest.mark.parametrize("h,w,n,sigma", _ISA_MOVES,
                         ids=[f"{h}-{w}-n{n}-s{s}" for h, w, n, s in _ISA_MOVES])
def test_tiny_jitted_poly_exp_moves_with_the_isa(avx2_answers, h, w, n, sigma):
    """Item 8's shapes where the jitted ``poly_exp`` compiled for AVX2 parts
    from the one compiled for this host's AVX-512: JAX's own bits move with
    the host, so a bit-equal test there could pass by accident on one host
    and fail on another.  The port's tiny form stays within 1e-5 of the
    plane scale of both."""
    img = _tiny_image(h, w)
    native, avx2 = _jit_poly_exp(img, n, sigma), avx2_answers[f"poly-{h}-{w}-{n}-{sigma}"]
    assert (native != avx2).any()
    got = fk.poly_exp_reference(_t(img), n, sigma).numpy()
    for want in (native, avx2):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


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
    """The packed table and its scales equal the jitted ``pack_corner_pairs``
    (XLA divides by the constant qmax as a multiply by its float32
    reciprocal), the form of the jitted flow."""
    rng = np.random.default_rng(w)
    R1 = rng.normal(size=(5, h, w)).astype(np.float32) * np.float32(30.0)
    R1[2, 0, 0] = 0.0
    jtable, jscale = jax.jit(jfb.pack_corner_pairs)(jnp.asarray(R1))
    table, scale = fb.pack_corner_pairs(_t(R1))
    assert table.dtype == torch.int32 and table.shape == (h * w, 7)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable).view(np.int32))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


# SHA-256 of the float32 bytes of JAX's jitted packed warp where its bits
# depend on the vector instructions XLA compiles for (``xla_isa``): the
# answer of an AVX-512 build (jax 0.9.0), which the port follows.  The AVX2
# build parts from it by up to 1.9e-6 at these cases.
_PACKED_DIGESTS = {
    "packed_update": "443c8402f880f6dddbbae94c0074e1205db652c25d2b84315a328bbd73526efa",
    "60x60-0.0": "ada66023d29af1522549feb68a500e8067b899eb6fd631134c438bc9927c08ba",
    "60x60-1.5": "63e8863acfd049cf949c47e55450c91dc25ae7bc5c034e9282a13378ad31acac",
    "60x60-6.0": "7cc7be916a005ef1e7ec36eebd35ac7449a2b3095af9911290b90ee935514a1d",
    "97x173-0.0": "75fed0de8bfbf2121e77cfb0b00bcfe2a9b1cbfc3f75f754016686488dbccacc",
    "97x173-1.5": "27310f7b80d2e1a2ab85d21463905d32c310561a76e8fd96338741c4c7ca0ca9",
    "97x173-6.0": "dbdd56567f14ab10f32bd1367f8cefaa239adca26788b367c6d2704ca81e815d",
    "40x48-0.0": "37ec47c36ca6413401dbc5ca0e73bde0fe6b29bbcb3922957d733c9a34d733e2",
    "40x48-1.5": "ca15b2bf80f5dcdf433377395d11bc5c38449d7254484e0d924c433e24c9abc1",
    "40x48-6.0": "5c816c6156935a2d6b03b4d78bbcae066e0fd0e785622ce8216cdb75d084768a",
    "60x60-plane": "2945da18cd4d1d85892481089866200c50359d371f6247b43c42689441f9a7b9",
    "60x60-scalar": "9ed42034e2bd4008a0655fd935687f5ec5cec7fdae3dae26446dcde8da19f2f4",
    "97x173-plane": "3991f3f90509916d272176d879083d71f83160941727aef212477e3ccaee182e",
    "97x173-scalar": "e13ce882ab84b377f28b74550303682e9eaf4054eb987d2bfea41e694824a2ae",
}


def _hold_packed(case, got, want):
    """The packed warp's M where JAX's bits depend on the host: the port has
    the recorded AVX-512 answer on every host (``xla_isa``), and is within
    1e-5 of the plane scale of JAX's answer on a host without AVX-512."""
    want = np.asarray(want)
    hold_to_recorded(got, want, _PACKED_DIGESTS[case], 1e-5 * np.abs(want).max())


def _packed_update_inputs():
    rng = np.random.default_rng(3)
    h, w = 97, 173
    R0, R1 = (rng.normal(size=(5, h, w)).astype(np.float32) for _ in range(2))
    dx, dy = (rng.normal(size=(h, w)).astype(np.float32) * 3 for _ in range(2))
    return R0, R1, dx, dy


def test_packed_update_matrices_matches_jax():
    """The quantized warp of the small levels (update_matrices with the packed
    table, K9's plain version) is the JAX package's jitted one compiled for
    AVX-512, bit for bit (held by its digest on any host)."""
    R0, R1, dx, dy = _packed_update_inputs()
    want = jax.jit(lambda a, b, c, d: jfb.update_matrices(a, b, c, d, jfb.pack_corner_pairs(b)))(
        *map(jnp.asarray, (R0, R1, dx, dy)))
    got = fk.warp_matrices_packed(_t(R0), _t(R1), fk.corner_scale(_t(R1)), _t(dx), _t(dy))
    _hold_packed("packed_update", got.numpy(), want)


def _packed_case(case):
    """The inputs of a packed-warp case of _PACKED_DIGESTS: (R0, R1, dx, dy,
    scale), scale None or the flow's scale (a plane or a float32 number)."""
    if case == "packed_update":
        return (*_packed_update_inputs(), None)
    shape, arg = case.split("-")
    h, w = map(int, shape.split("x"))
    if arg in ("plane", "scalar"):
        R0, R1, nx, ny = _warp_inputs(h, w, 2.0, h + w)
        scale = (np.random.default_rng(w).uniform(0.5, 1.5, (h, w)).astype(np.float32)
                 if arg == "plane" else np.float32(1 / 0.3))
        return R0, R1, nx, ny, scale
    flow = float(arg)
    return (*_warp_inputs(h, w, flow, h * w + int(flow)), None)


@functools.lru_cache(maxsize=1)
def _refine_pyramids():
    """The jitted pyramids of ``tests/test_torch_farneback.py``'s 200x200
    refinement (``make_frames(3, 200, 200, seed=3)``, poly_sigma 1.1)."""
    build = jax.jit(lambda im: jfb.build_pyramid(im, 0.3, 5, 5, 1.1, use_pallas=False))
    return [build(jnp.asarray(f)) for f in make_frames(3, 200, 200, seed=3)[:2].astype(np.float32)]


def _packed_jax(case):
    """JAX's jitted answer of a packed-warp case: M of a _PACKED_DIGESTS case,
    or the 200x200 packed refinement ("refine-box", "refine-gauss")."""
    if case.startswith("refine-"):
        p1, p2 = _refine_pyramids()
        return np.asarray(jax.jit(lambda x, y: jfb.flow_from_pyramids(
            x, y, 0.3, 15, 5, use_pallas=False, fast_warp=True,
            gaussian=case == "refine-gauss"))(p1, p2))
    R0, R1, dx, dy, scale = _packed_case(case)
    return np.asarray(_jit_update(True)(R0, R1, dx, dy, *([] if scale is None else [scale])))


def _packed_port(case):
    """The port's answer of a packed-warp case (``_packed_jax``)."""
    if case.startswith("refine-"):
        p1, p2 = (tuple(_t(q) for q in p) for p in _refine_pyramids())
        return fb.flow_from_pyramids(p1, p2, 0.3, 15, 5, fast_warp=True,
                                     gaussian=case == "refine-gauss").numpy()
    R0, R1, dx, dy, scale = _packed_case(case)
    s = None if scale is None else _t(scale) if scale.ndim else float(scale)
    return fk.warp_matrices_packed(_t(R0), _t(R1), fk.corner_scale(_t(R1)), _t(dx), _t(dy),
                                   s).numpy()


_PACKED_MOVES = (*_PACKED_DIGESTS, "refine-box", "refine-gauss")


@pytest.mark.parametrize("case", _PACKED_MOVES)
def test_packed_warp_moves_with_the_isa(avx2_answers, case):
    """The packed warp's cases held by digest: JAX's jitted answer compiled
    for AVX2 parts from the one compiled for AVX-512 (by up to 1.9e-6 in M,
    4.9e-6 px in the flow), so no bit-equal test can hold both hosts.  The
    port stays within 1e-5 of the plane scale of both answers (the flow
    within 1e-4 px)."""
    native, avx2 = _packed_jax(case), avx2_answers[f"packed-{case}"]
    assert (native != avx2).any()
    got = _packed_port(case)
    for want in (native, avx2):
        tol = 1e-4 if case.startswith("refine-") else 1e-5 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol


def _warp_inputs(h, w, flow, seed):
    """Planes R0, R1 and a flow: zero, or seeded normal of 1.5 px (some
    pixels outside the warp), or 6 px (many outside)."""
    rng = np.random.default_rng(seed)
    R0, R1 = (rng.normal(size=(5, h, w)).astype(np.float32) for _ in range(2))
    dx, dy = (rng.normal(size=(h, w)).astype(np.float32) * np.float32(flow) for _ in range(2))
    return R0, R1, dx, dy


def _jit_update(packed, product=None):
    """The jitted ``update_matrices``, exact or packed; with ``product`` its
    flow is ``(dx, dy) * scale``, a product XLA recomputes in the warp."""
    def run(R0, R1, dx, dy, *scale):
        if scale:
            dx, dy = dx * scale[0], dy * scale[0]
        return jfb.update_matrices(R0, R1, dx, dy, jfb.pack_corner_pairs(R1) if packed else None)
    return jax.jit(run)


_UPDATE_SHAPES = [(60, 60), (97, 173), (40, 48), (1, 64), (64, 1)]


@pytest.mark.parametrize("packed", [False, True], ids=["exact", "packed"])
@pytest.mark.parametrize("flow", [0.0, 1.5, 6.0])
@pytest.mark.parametrize("h,w", _UPDATE_SHAPES, ids=[f"{h}x{w}" for h, w in _UPDATE_SHAPES])
def test_update_matrices_bit_equal_to_jitted_jax(h, w, flow, packed):
    """K4's and K9's plain versions (the exact and the packed
    ``update_matrices``) equal the jitted JAX function bit for bit: at the
    small levels' shapes, at a narrow width (40x48: XLA's vector loops end
    at column 40) and on levels of one row or column (no pixel inside), at
    zero flow and at seeded flows that leave pixels outside the warp.  The
    packed warp's cases whose JAX bits depend on the host's vector
    instructions are held to the AVX-512 answer's digest (_hold_packed)."""
    R0, R1, dx, dy = _warp_inputs(h, w, flow, h * w + int(flow))
    want = np.asarray(_jit_update(packed)(R0, R1, dx, dy))
    if packed:
        got = fk.warp_matrices_packed(_t(R0), _t(R1), fk.corner_scale(_t(R1)), _t(dx), _t(dy))
    else:
        got = fk.warp_matrices(*map(_t, (R0, R1, dx, dy)))
    if packed and f"{h}x{w}-{flow}" in _PACKED_DIGESTS:
        _hold_packed(f"{h}x{w}-{flow}", got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if flow == 6.0 and min(h, w) > 1:
        fy = np.arange(h)[:, None] + dy
        assert ((fy < 0) | (fy >= h - 1)).any()  # pixels outside the warp


@pytest.mark.parametrize("packed", [False, True], ids=["exact", "packed"])
@pytest.mark.parametrize("kind", ["plane", "scalar"])
@pytest.mark.parametrize("h,w", [(60, 60), (97, 173), (1, 64)])
def test_update_matrices_with_a_recomputed_flow_bit_equal_to_jitted_jax(h, w, kind, packed):
    """The flow as XLA's compiled refinement carries it into a warp:
    ``(nx, ny) * idet`` after a solve (kind "plane") or the upsampled flow
    times 1 / pyr_scale ("scalar").  XLA recomputes the product in the warp
    and contracts it into the position, ``fma(nx, idet, j)``; the plain
    versions take it as ``flow_scale``.  Packed cases as above."""
    R0, R1, nx, ny = _warp_inputs(h, w, 2.0, h + w)
    scale = (np.random.default_rng(w).uniform(0.5, 1.5, (h, w)).astype(np.float32)
             if kind == "plane" else np.float32(1 / 0.3))
    want = np.asarray(_jit_update(packed)(R0, R1, nx, ny, scale))
    s = _t(scale) if kind == "plane" else float(scale)
    if packed:
        got = fk.warp_matrices_packed(_t(R0), _t(R1), fk.corner_scale(_t(R1)), _t(nx), _t(ny), s)
    else:
        got = fk.warp_matrices(*map(_t, (R0, R1, nx, ny)), s)
    if packed and f"{h}x{w}-{kind}" in _PACKED_DIGESTS:
        _hold_packed(f"{h}x{w}-{kind}", got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# Tiny warps whose jitted JAX bits move with the vector instructions XLA
# compiles for (measured against an AVX2 build): the exact warp on 3-4
# columns of 16 rows or more, the packed warp on 2-9 rows of 60 columns
# (warp, h, w, flow amplitude)
_ISA_WARPS = [("exact", 40, 3, 6.0), ("exact", 40, 4, 1.5), ("exact", 64, 3, 1.5),
              ("exact", 33, 4, 6.0), ("packed", 5, 60, 0.0), ("packed", 7, 60, 1.5)]


def _isa_warp(warp, h, w, flow):
    """(the port's M, JAX's jitted M) of an _ISA_WARPS case."""
    R0, R1, dx, dy = _warp_inputs(h, w, flow, h * w + int(flow))
    want = np.asarray(_jit_update(warp == "packed")(R0, R1, dx, dy))
    if warp == "packed":
        got = fk.warp_matrices_packed(_t(R0), _t(R1), fk.corner_scale(_t(R1)), _t(dx), _t(dy))
    else:
        got = fk.warp_matrices(*map(_t, (R0, R1, dx, dy)))
    return got.numpy(), want


@pytest.mark.parametrize("warp,h,w,flow", _ISA_WARPS,
                         ids=[f"{p}-{h}x{w}-{f}" for p, h, w, f in _ISA_WARPS])
def test_tiny_warps_move_with_the_isa(avx2_answers, warp, h, w, flow):
    """Where the jitted ``update_matrices`` compiled for AVX2 parts from the
    one compiled for AVX-512 (the loops over these few columns or rows
    vectorise otherwise), no single answer is XLA's: the port stays within
    1e-5 of the plane scale of both."""
    got, native = _isa_warp(warp, h, w, flow)
    avx2 = avx2_answers[f"warp-{warp}-{h}x{w}-{flow}"]
    assert (native != avx2).any()
    for want in (native, avx2):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# Levels of 2-4 rows and columns, whose attenuation XLA folds to one scalar
# (``ops/farneback.uniform_attenuation``), a line of 4, and thin levels of 2-4
# rows or columns
_TINY_UPDATE = [(2, 2), (3, 3), (4, 4), (2, 4), (4, 2), (3, 4), (4, 3), (2, 3), (3, 2), (1, 4),
                (4, 1), (2, 64), (64, 2), (3, 40), (4, 40)]


@pytest.mark.parametrize("flow", [0.0, 1.5, "plane", "scalar"])
@pytest.mark.parametrize("h,w", _TINY_UPDATE, ids=[f"{h}x{w}" for h, w in _TINY_UPDATE])
def test_exact_update_matrices_bit_equal_at_tiny_levels(h, w, flow):
    """K4's plain version on tiny levels equals the jitted ``update_matrices``
    bit for bit, with a given flow and with the flow as the refinement
    carries it (times a plane or a number, ``flow_scale``): where the
    attenuation is one value (at most 4 rows and columns) XLA's tail takes
    the unfolded form ``fma(R4, R4, R6 R6)``, ``fma(r4, s, R5) R6``, ...
    (on a line, ``(R4 + R5) R6``)."""
    amp = 2.0 if isinstance(flow, str) else flow
    R0, R1, dx, dy = _warp_inputs(h, w, amp, h * w + int(amp))
    if flow == "plane":
        scale = np.random.default_rng(w).uniform(0.5, 1.5, (h, w)).astype(np.float32)
    elif flow == "scalar":
        scale = np.float32(1 / 0.3)
    else:
        scale = None
    extra = [] if scale is None else [scale]
    want = np.asarray(_jit_update(False)(R0, R1, dx, dy, *extra))
    s = None if scale is None else _t(scale) if scale.ndim else float(scale)
    got = fk.warp_matrices(*map(_t, (R0, R1, dx, dy)), s)
    np.testing.assert_array_equal(got.numpy(), want)


# Levels with an axis of at most the Gaussian window's radius and the other
# of 5 or more: taps that read only edge padding (``ops/farneback.
# broadcast_taps``)
_THIN_WINDOWS = [(3, 40), (40, 3), (4, 40), (40, 4), (60, 6), (6, 60), (7, 60), (60, 7), (7, 7),
                 (2, 64), (8, 3), (8, 5), (5, 40), (40, 5)]


@pytest.mark.parametrize("win", [5, 15])
@pytest.mark.parametrize("h,w", _THIN_WINDOWS, ids=[f"{h}x{w}" for h, w in _THIN_WINDOWS])
def test_gauss_blur5_bit_equal_where_an_axis_is_within_the_radius(h, w, win):
    """The Gaussian window where some taps read only the edge padding: a
    lead of one such tap keeps its product's rounding, the vertical sums'
    trailing ones are contracted but in the edge columns that pad them, and
    the horizontal pass adds its trailing ones rounded, as the jitted
    ``gauss_blur5``."""
    M = _planes((h, w), seed=h + w + win)
    want = np.asarray(jax.jit(lambda m: jfb.gauss_blur5(m, win))(jnp.asarray(M)))
    np.testing.assert_array_equal(fb.gauss_blur5(_t(M), win).numpy(), want)


@pytest.mark.parametrize("win", [5, 15])
@pytest.mark.parametrize("h,w", [(60, 60), (97, 173), (40, 48), (1, 64), (64, 1)])
def test_gauss_blur5_bit_equal_to_jitted_jax(h, w, win):
    """The Gaussian window: each pass a chain of once-rounded fmas, as the
    jitted ``gauss_blur5`` (on an axis of one value the products of equal
    taps are added separately rounded, as XLA shares them there)."""
    M = _planes((h, w), seed=h + w + win)
    want = np.asarray(jax.jit(lambda m: jfb.gauss_blur5(m, win))(jnp.asarray(M)))
    np.testing.assert_array_equal(fb.gauss_blur5(_t(M), win).numpy(), want)


@pytest.mark.parametrize("h,w", [(60, 60), (97, 173), (1, 64)])
def test_solve_flow_bit_equal_to_jitted_jax(h, w):
    """The 2x2 solve: each difference of products ``fma(a, b, -(c d))``, as
    the jitted ``solve_flow``."""
    M = _planes((h, w), seed=h * w)
    want = jax.jit(jfb.solve_flow)(jnp.asarray(M))
    for g, e in zip(fb.solve_flow(_t(M)), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("gaussian", [False, True], ids=["box", "gauss"])
@pytest.mark.parametrize("h,w", [(60, 60), (130, 300)])
def test_window_kernels_plain_versions_bit_equal_to_jitted_jax(h, w, gaussian):
    """K2's and K3's plain versions equal the jitted jnp window + solve and
    the jitted jnp iteration (warp, window, solve); with ``terms`` K2 gives
    the numerators and 1 / det whose products are the flow."""
    R0, R1, dx, dy = _warp_inputs(h, w, 2.0, h + w + gaussian)
    blur = jfb.gauss_blur5 if gaussian else jfb.box_blur5
    M = _planes((h, w), seed=h)
    want = jax.jit(lambda m: jfb.solve_flow(blur(m, 15)))(jnp.asarray(M))
    got = fk.blur_solve(_t(M), 15, gaussian)
    nx, ny, idet = fk.blur_solve(_t(M), 15, gaussian, terms=True)
    for g, t, e in zip(got, (nx * idet, ny * idet), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_array_equal(t.numpy(), np.asarray(e))
    want = jax.jit(lambda *a: jfb.solve_flow(blur(jfb.update_matrices(*a), 15)))(
        *map(jnp.asarray, (R0, R1, dx, dy)))
    got = fk.fused_iteration(*map(_t, (R0, R1, dx, dy)), 15, gaussian)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_out_of_window_flow_takes_the_exact_warp():
    """Flow beyond the JAX TPU kernel's warp window: JAX falls back to the
    packed int16/int8 warp, the port keeps the exact fused iteration, i.e. the
    exact update_matrices -> box window -> solve of the JAX jnp path, bit for
    bit against its jitted form."""
    h, w = 160, 384
    rng = np.random.default_rng(7)
    R0, R1 = (rng.normal(size=(5, h, w)).astype(np.float32) for _ in range(2))
    dx = np.full((h, w), 100.0, np.float32)  # far past the window's floor(dx) <= 62
    dy = np.zeros((h, w), np.float32)
    assert not bool(warp_pallas.flow_in_range(jnp.asarray(dx), jnp.asarray(dy)))
    assert not bool(warp.flow_in_range(_t(dx), _t(dy)))
    gdx, gdy = fb.farneback_level(*map(_t, (R0, R1, dx, dy)), winsize=15, iterations=1)
    edx, edy = jax.jit(lambda *a: jfb.solve_flow(jfb.box_blur5(jfb.update_matrices(*a), 15)))(
        *map(jnp.asarray, (R0, R1, dx, dy)))
    np.testing.assert_array_equal(gdx.numpy(), np.asarray(edx))
    np.testing.assert_array_equal(gdy.numpy(), np.asarray(edy))
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


@pytest.mark.parametrize("name", ["datmo_poly_exp", "datmo_poly_exp_tiny", "datmo_blur_solve",
                                  "datmo_fused_iteration", "datmo_warp_matrices",
                                  "datmo_warp_packed", "datmo_corner_scale"])
def test_c_signatures_match_the_source(name):
    """``kernels/build`` binds each flow kernel's entry point with as many
    arguments as ``csrc/flow_kernels.cu`` declares (the C compiler here
    cannot check what ctypes passes)."""
    from datmo_using_optical_flow_tpu_torch.kernels import build

    text = (build.CSRC_DIR / "flow_kernels.cu").read_text()
    head = text[text.index(f"int {name}("):]
    assert len(build._SIGNATURES[name][0]) == len(head[:head.index(")")].split(","))


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
    R1 = torch.rand(5, 40, 48)
    fk.warp_matrices_packed(torch.rand(5, 40, 48), R1, fk.corner_scale(R1),
                            torch.zeros(40, 48), torch.zeros(40, 48), torch.ones(40, 48))
    assert fk.LAUNCHES == {"poly_exp": 0, "blur_solve": 0, "fused_iteration": 0,
                           "warp_matrices": 0, "warp_packed": 0, "corner_scale": 0}
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fk.poly_exp(torch.empty(40, 48, device="meta"), 5, 5.0)
    with pytest.raises(ValueError, match="contiguous"):
        fk.poly_exp(torch.rand(48, 40).T, 5, 5.0)
    with pytest.raises(TypeError, match="float32"):
        fk.blur_solve(torch.rand(5, 40, 48, dtype=torch.float64), 15)
    with pytest.raises(ValueError, match="winsize"):
        fk.blur_solve(torch.rand(5, 40, 48), 65)


# K1's tiny kernel runs its rounding plan as a program (ops/poly_tiny.
# tiny_program): per block, stage 1 writes every vertical-sum variant at the
# tile's rows and staged columns, stage 2 forms the seven horizontal chains
# of each pixel from them.  _run_tiny_program does what the kernel does, block
# by block, in PyTorch, so that the program and the tiles the card runs are
# held to the plain version here, at each of chip_smoke.py's tiny cases.
def _tiny_step(op, c, x, acc):
    from datmo_using_optical_flow_tpu_torch.ops import poly_tiny as pt
    from datmo_using_optical_flow_tpu_torch.ops.round_kernels import fma32_reference as fma

    out, c0, x0 = acc
    p = c * x
    if op == pt.FIRST:
        return p, c, x
    if op == pt.FUSE0:
        return fma(x0, c0, p), c0, x0
    if op == pt.FMA:
        return fma(x, c, out), c0, x0
    if op == pt.ADD:
        return out + p, c0, x0
    return acc


def _run_tiny_program(img, n, sigma):
    from datmo_using_optical_flow_tpu_torch.ops import poly_tiny as pt
    from datmo_using_optical_flow_tpu_torch.ops.round_kernels import fma32_reference as fma

    h, w = img.shape
    prog = pt.tiny_program(h, w, n, sigma)
    nv, tile_rows, tile_cols = (int(x) for x in prog[:3])
    end = 3 + pt.MAX_VARIANTS * (1 + pt.OPS)
    var = prog[3:end].reshape(pt.MAX_VARIANTS, 1 + pt.OPS)
    sums = prog[end:].reshape(7, pt.SUM_INTS)
    *kerns, igs = pt._taps(n, float(sigma))
    kerns = [torch.from_numpy(k) for k in kerns]
    out = torch.full((5, h, w), float("nan"))
    for i0 in range(0, h, tile_rows):
        for j0 in range(0, w, tile_cols):
            rows, cols = min(tile_rows, h - i0), min(tile_cols, w - j0)
            c_lo, c_hi = max(0, j0 - n), min(w, j0 + cols + n)
            r = torch.arange(i0, i0 + rows)
            staged = []  # stage 1: (nv, rows, staged columns)
            for v in range(nv):
                acc = (None, None, None)
                for k in range(2 * n + 1):
                    x = img[(r + k - n).clamp(0, h - 1)][:, c_lo:c_hi]
                    acc = _tiny_step(var[v, 1 + k], kerns[var[v, 0]][k], x, acc)
                staged.append(acc[0])
            staged = torch.stack(staged)
            j = torch.arange(j0, j0 + cols)
            s = []  # stage 2
            for row in sums:
                kind, ops, fix = row[0], row[1:1 + pt.OPS], row[1 + pt.OPS:1 + 2 * pt.OPS]
                v_int, v_pad, v_rem, rem_start = (int(x) for x in row[1 + 2 * pt.OPS:])
                acc = (None, None, None)
                for k in range(2 * n + 1):
                    if ops[k] == pt.SKIP:
                        continue
                    col = j + k - n
                    v = torch.where((col >= 0) & (col < w),
                                    torch.where(col >= rem_start, v_rem, v_int), v_pad)
                    if fix[k] >= 0:
                        v = torch.full_like(v, int(fix[k]))
                    x = staged[v, :, col.clamp(0, w - 1) - c_lo].T
                    acc = _tiny_step(ops[k], kerns[kind][k], x, acc)
                s.append(acc[0])
            ig11, ig03, ig33, ig55 = (float(x) for x in igs)
            out[:, i0:i0 + rows, j0:j0 + cols] = torch.stack([
                s[0] * ig11, s[1] * ig11, fma(s[2], ig33, s[3] * ig03),
                fma(s[4], ig33, s[5] * ig03), s[6] * ig55])
    return out


def _chip_tiny_cases():
    import chip_smoke

    from datmo_using_optical_flow_tpu_torch.ops import poly_tiny as pt

    return [c for c in chip_smoke.K1_TINY_CASES if pt.is_tiny(*c[:3])]


_CHIP_TINY = _chip_tiny_cases()


@pytest.mark.parametrize("h,w,n,sigma", _CHIP_TINY,
                         ids=[f"{h}-{w}-n{n}-s{s}" for h, w, n, s in _CHIP_TINY])
def test_tiny_program_runs_as_the_plain_version(h, w, n, sigma):
    """The tiny kernel's program, run block by block as the kernel runs it,
    gives the plain version's bits at every tiny case that chip_smoke.py
    holds the card to: the operations per tap carry each chain's rounding,
    the staged columns and the fixed variants carry its reads."""
    img = torch.from_numpy(_tiny_image(h, w))
    want = fk.poly_exp_reference(img, n, sigma)
    assert torch.equal(_run_tiny_program(img, n, sigma), want)


@pytest.mark.parametrize("h,w,n,sigma", _CHIP_TINY,
                         ids=[f"{h}-{w}-n{n}-s{s}" for h, w, n, s in _CHIP_TINY])
def test_tiny_tiles_cover_every_pixel_and_fit_shared_memory(h, w, n, sigma):
    """The kernel's grid of tiles (``poly_tiny.tiny_tiles``) covers each pixel
    once, a long axis spreads over several blocks, every column a block's
    chains read is staged, and a block's shared memory fits the default 48
    KB; the program's operations skip every tap past 2n and each variant it
    names exists."""
    from datmo_using_optical_flow_tpu_torch.ops import poly_tiny as pt

    prog = pt.tiny_program(h, w, n, sigma)
    nv, tile_rows, tile_cols = (int(x) for x in prog[:3])
    assert (tile_rows, tile_cols) == pt.tiny_tiles(h, w, n, nv)
    assert (tile_rows == h) if h <= n else (tile_cols == w)
    covered = np.zeros((h, w), np.int32)
    for i0 in range(0, h, tile_rows):
        for j0 in range(0, w, tile_cols):
            rows, cols = min(tile_rows, h - i0), min(tile_cols, w - j0)
            covered[i0:i0 + rows, j0:j0 + cols] += 1
            c_lo, c_hi = max(0, j0 - n), min(w, j0 + cols + n)
            reads = np.clip(np.arange(j0 - n, j0 + cols + n), 0, w - 1)
            assert c_lo <= reads.min() and reads.max() < c_hi
            assert c_hi - c_lo <= min(w, tile_cols + 2 * n)
    assert (covered == 1).all()
    if max(h, w) > 2 * pt.TILE:
        assert -(-h // tile_rows) * -(-w // tile_cols) > 2
    assert pt.tiny_smem_bytes(w, n, nv, (tile_rows, tile_cols)) <= pt.SMEM_LIMIT
    end = 3 + pt.MAX_VARIANTS * (1 + pt.OPS)
    ops = np.concatenate([prog[3:end].reshape(pt.MAX_VARIANTS, -1)[:, 1:],
                          prog[end:].reshape(7, pt.SUM_INTS)[:, 1:1 + pt.OPS]])
    assert (ops[:, 2 * n + 1:] == pt.SKIP).all() and ops.max() <= pt.ADD
    fix = prog[end:].reshape(7, pt.SUM_INTS)[:, 1 + pt.OPS:1 + 2 * pt.OPS]
    reads = prog[end:].reshape(7, pt.SUM_INTS)[:, 1 + 2 * pt.OPS:-1]
    assert fix.min() >= -1 and fix.max() < nv and reads.min() >= 0 and reads.max() < nv


def test_tiny_program_layout_matches_the_source():
    """``poly_tiny``'s program constants are the kernel's: operations per
    chain, variants, the operation codes, threads' tile and shared memory."""
    from datmo_using_optical_flow_tpu_torch.kernels import build
    from datmo_using_optical_flow_tpu_torch.ops import poly_tiny as pt

    text = (build.CSRC_DIR / "flow_kernels.cu").read_text()
    assert f"constexpr int kTinyOps = {pt.OPS};" in text
    assert f"constexpr int kTinyVariants = {pt.MAX_VARIANTS};" in text
    assert f"constexpr int kTinySmem = {pt.SMEM_LIMIT // 1024} * 1024;" in text
    assert f"constexpr int kTinyThreads = {pt.THREADS};" in text
    assert ("enum TinyOp { kSkip = %d, kFirst = %d, kFuse0 = %d, kFma = %d, kAdd = %d };"
            % (pt.SKIP, pt.FIRST, pt.FUSE0, pt.FMA, pt.ADD)) in text
    assert pt.PROGRAM_INTS == 3 + pt.MAX_VARIANTS * (1 + pt.OPS) + 7 * (5 + 2 * pt.OPS)
