"""K9, the small levels' packed warp, in the form that quantises its corners
from R1: its scale pass (``flow_kernels.corner_scale``) and its warp
(``flow_kernels.warp_matrices_packed(R0, R1, scale, ...)``).

Here on the CPU both wrappers take their plain versions, which these tests
hold bit for bit to the JAX package's jitted ``pack_corner_pairs`` and packed
``update_matrices``, and to the table form (``update_matrices`` over
``pack_corner_pairs``' table), whose bits the card's kernel is held to by
``chip_smoke.py``.  Bits are compared as int32, so a zero's sign counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from xla_isa import XLA_AVX512


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _planes(h, w, seed, amp=30.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(5, h, w)).astype(np.float32) * np.float32(amp)


_SCALE_SHAPES = [(1, 1), (5, 122), (60, 60), (97, 173), (200, 200)]


@pytest.mark.parametrize("zero_plane", [False, True], ids=["planes", "zero-plane"])
@pytest.mark.parametrize("h,w", _SCALE_SHAPES, ids=[f"{h}x{w}" for h, w in _SCALE_SHAPES])
def test_corner_scale_bit_equal_to_jitted_jax(h, w, zero_plane):
    """The scale pass's plain version is the scale of the jitted
    ``pack_corner_pairs`` bit for bit; an all-zero plane takes the 1e-20
    clamp."""
    R1 = _planes(h, w, h * w + zero_plane)
    if zero_plane:
        R1[3] = 0.0
        R1[1] = -0.0
    _, jscale = jax.jit(jfb.pack_corner_pairs)(jnp.asarray(R1))
    got = fk.corner_scale(_t(R1))
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_array_equal(_bits(fk.corner_scale_reference(_t(R1))), _bits(got))
    np.testing.assert_array_equal(_bits(got), _bits(jscale))
    np.testing.assert_array_equal(_bits(fb.pack_corner_pairs(_t(R1))[1]), _bits(got))
    if zero_plane:  # max(0, 1e-20) * fl(1 / qmax)
        tiny = np.float32(1e-20)
        assert float(got[1]) == float(tiny * (np.float32(1) / np.float32(32767)))
        assert float(got[3]) == float(tiny * (np.float32(1) / np.float32(127)))


def _carried(R0, R1):
    """The flow the refinement carries between iterations at this level: the
    solve's numerators and 1 / det (K2's plain version) of the packed M at
    zero flow."""
    zero = torch.zeros(R0.shape[1:])
    M = fk.warp_packed_reference(R0, R1, fk.corner_scale(R1), zero, zero)
    return fk.blur_solve_reference(M, 15, False, terms=True)


def _case(h, w, flow):
    """(R0, R1, dx, dy, flow_scale) of a case: a zero flow, seeded normal
    flows of 1.5 px and 6 px (pixels outside the warp), or the carried
    (nx, ny, 1/det)."""
    R0, R1 = (_t(_planes(h, w, 7 * h + w + k, 1.0)) for k in range(2))
    if flow == "carried":
        return (R0, R1, *_carried(R0, R1))
    rng = np.random.default_rng(h + 3 * w)
    dx, dy = (_t(rng.normal(size=(h, w)).astype(np.float32) * np.float32(flow))
              for _ in range(2))
    return R0, R1, dx, dy, None


def _jax_packed(R0, R1, dx, dy, s):
    """JAX's jitted packed ``update_matrices``; the flow ``(dx, dy) * s``
    recomputed in the warp when ``s`` is given."""
    def run(R0, R1, dx, dy, *s):
        if s:
            dx, dy = dx * s[0], dy * s[0]
        return jfb.update_matrices(R0, R1, dx, dy, jfb.pack_corner_pairs(R1))
    args = [R0, R1, dx, dy] + ([] if s is None else [s])
    return np.asarray(jax.jit(run)(*(jnp.asarray(a.numpy()) for a in args)))


_WARP_SHAPES = [(5, 122), (1, 173), (97, 1), (60, 60), (97, 173)]
_FLOWS = [0.0, 1.5, 6.0, "carried"]
# Shapes where JAX's jitted bits depend on the vector instructions XLA
# compiles for (measured against an AVX2 build: 60x60 and 97x173 at every
# flow here), and where the port's packed warp is ROADMAP Queue 3 item 13's
# (at most 8 rows of 100 or more columns: M3 and M4 part from JAX's by an
# ulp at a few values, the table form as the R1 form; 5x122 moves with the
# ISA too at the carried flow)
_ISA_MOVES = {(60, 60), (97, 173)}
_ITEM_13 = {(5, 122)}


@pytest.mark.parametrize("flow", _FLOWS, ids=[str(f) for f in _FLOWS])
@pytest.mark.parametrize("h,w", _WARP_SHAPES, ids=[f"{h}x{w}" for h, w in _WARP_SHAPES])
def test_r1_form_bit_equal_to_table_form_and_jitted_jax(h, w, flow):
    """The R1 form of K9's plain version equals the table form bit for bit
    at every case, and JAX's jitted packed ``update_matrices``: bit for bit
    where JAX's bits do not depend on the host (1x173 and 97x1, no pixel
    inside); where they do, bit for bit where XLA compiles for AVX-512 (the
    answer the port follows: ``xla_isa``) and else within 1e-5 of the plane
    scale; at Queue 3 item 13's 5x122 (the ``vec`` rule's scalar remainder
    at 122 columns) within 1e-5 of the plane scale, M3 and M4 alone
    differing."""
    R0, R1, dx, dy, s = _case(h, w, flow)
    scale = fk.corner_scale(R1)
    got = fk.warp_matrices_packed(R0, R1, scale, dx, dy, s)
    table = fb.update_matrices(R0, None, dx, dy, fb.pack_corner_pairs(R1), s)
    np.testing.assert_array_equal(_bits(got), _bits(table))
    want = _jax_packed(R0, R1, dx, dy, s)
    if (h, w) in _ITEM_13:
        assert (_bits(got)[:3] == _bits(want)[:3]).all()
    if (h, w) in _ITEM_13 or ((h, w) in _ISA_MOVES and not XLA_AVX512):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _negative_zero_case(h=12, w=40):
    """R0 of -0.0 and R1 whose corners lie in (-scale / 2, 0) but for one
    value a plane that sets its scale: each such corner quantises to 0, which
    a float-only rounding would give as -0.0."""
    R0 = torch.full((5, h, w), -0.0)
    rng = np.random.default_rng(11)
    R1 = -_t(rng.uniform(0.01, 0.45, (5, h, w)).astype(np.float32))
    R1[:, h - 1, w - 1] = torch.tensor([32767.0, 32767.0, 127.0, 127.0, 127.0])
    return R0, R1  # scale 1.0 on every plane


def _float_only_M(R0, R1, scale):
    """M at zero flow with each corner quantised without the pass through an
    integer (``torch.round`` keeps -0.0), for the test's teeth."""
    qmax = torch.tensor([32767.0, 32767.0, 127.0, 127.0, 127.0])[:, None, None]
    q = torch.clamp(torch.round(R1 / scale[:, None, None]), -qmax, qmax)
    _, h, w = R0.shape
    ones, zeros = torch.ones(h * w), torch.zeros(h * w)
    c = q.reshape(5, -1)
    # zero flow: a00 = 1, the other weights 0; the int16 planes' chain first
    r = [fb._bilinear((zeros, ones, zeros, zeros), (c[ch], c[ch], c[ch], c[ch]))
         if ch < 2 else fb._bilinear((ones, zeros, zeros, zeros), (c[ch],) * 4)
         for ch in range(5)]
    r = torch.stack([v.reshape(h, w) for v in r])
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    inside = (xx < w - 1) & (yy < h - 1)
    zero = torch.zeros((h, w))
    return fb.matrices_from_samples(R0, r, inside, zero, zero, fb._border_scale(h, w, "cpu"),
                                    scale, False)


def test_corners_near_zero_give_the_tables_zero_signs():
    """Corners in (-scale / 2, 0) quantise to +0.0, as the table's integers
    give them: M's bits, zero signs included, equal the table form's and
    JAX's, and differ from a float-only rounding's (which keeps -0.0)."""
    R0, R1 = _negative_zero_case()
    _, h, w = R0.shape
    scale = fk.corner_scale(R1)
    assert torch.equal(scale, torch.ones(5))
    zero = torch.zeros((h, w))
    got = fk.warp_matrices_packed(R0, R1, scale, zero, zero)
    table = fb.update_matrices(R0, None, zero, zero, fb.pack_corner_pairs(R1))
    np.testing.assert_array_equal(_bits(got), _bits(table))
    np.testing.assert_array_equal(_bits(got), _bits(_jax_packed(R0, R1, zero, zero, None)))
    naive = _float_only_M(R0, R1, scale)
    assert torch.signbit(torch.round(R1[:, :-1, :-1])).all()
    assert torch.equal(naive, got)  # equal as numbers ...
    assert (_bits(naive) != _bits(got)).any()  # ... but not as bits: the signs differ


def _kernel_rint(v, s, qmax, rs_ulps=0):
    """The rule by which K9's kernel quantises v with the scale s
    (``csrc/flow_kernels.cu::Quantiser``), in float32 numpy arithmetic (IEEE,
    round to nearest, as the card's ``__fmul_rn``): rint of ``qa = v * rs``
    unless qa lies within ``|qa| 2^-21`` of a half-integer, where rint of the
    IEEE quotient decides; then clipped to +-qmax through an integer.
    ``rs`` is RN(1 / s) moved by ``rs_ulps`` (the card's ``rcp.approx`` is
    within 1 ulp of 1 / s).  Returns (result, fallbacks)."""
    f32 = np.float32
    rs = f32(1) / s
    for _ in range(abs(rs_ulps)):
        rs = np.nextafter(rs, f32(np.inf if rs_ulps > 0 else 0))
    with np.errstate(invalid="ignore", over="ignore"):
        qa = (v * rs).astype(f32)
        n = np.rint(qa)
        fast = (f32(0.5) - np.abs(qa - n)).astype(f32) > (np.abs(qa) * f32(2.0 ** -21))
        n = np.where(fast, n, np.rint(v / s))
        # __float2int_rn: a NaN gives 0, beyond int32 saturates
        n = np.clip(np.nan_to_num(n, nan=0.0), -2.0 ** 31, 2.0 ** 31 - 1)
    return np.clip(n.astype(np.int64), -qmax, qmax).astype(f32), int((~fast).sum())


def test_kernel_quantisation_rule_equals_the_division():
    """The kernel's multiply-then-check quantisation gives rint of the IEEE
    quotient at every value, with a reciprocal up to 2 ulps off (the card's is
    within 1): random planes at their own scales, and values within a few ulps
    of half-integer quotients across the int16 and int8 ranges (where the
    product's rounding could cross), with both of its branches taken."""
    rng = np.random.default_rng(22)
    for qmax in (32767, 127):
        for _ in range(4):
            plane = (rng.normal(size=200_000) * rng.uniform(1e-3, 1e3)).astype(np.float32)
            s = np.float32(np.float32(np.abs(plane).max()) * (np.float32(1) / np.float32(qmax)))
            k = rng.integers(-qmax, qmax, 200_000).astype(np.float32)
            half = ((k + np.float32(0.5)) * s).astype(np.float32)
            ulps = rng.integers(-4, 5, 200_000)
            near = np.nextafter(half, np.where(ulps < 0, -np.inf, np.inf).astype(np.float32))
            for _ in range(3):  # up to 4 ulps away, by repeated steps of the sign's direction
                near = np.where(np.abs(ulps) > 1, np.nextafter(
                    near, np.where(ulps < 0, -np.inf, np.inf).astype(np.float32)), near)
            values = np.concatenate([plane, half, near, np.float32([0.0, -0.0, np.nan])])
            want = fb.pack_corners(torch.as_tensor(np.tile(values, (5, 1))[:, None, :]),
                                   torch.full((5,), float(s)))
            want = want.view(-1, 7)  # the table's quantised corners A, int16 and int8
            a16 = (want[:, 0] >> 16).to(torch.int16).to(torch.float32).numpy()
            a8 = (want[:, 4] >> 24).to(torch.int8).to(torch.float32).numpy()
            for rs_ulps in (-2, -1, 0, 1, 2):  # the reciprocal up to 2 ulps off
                got, fallbacks = _kernel_rint(values, s, qmax, rs_ulps)
                np.testing.assert_array_equal(_bits(got), _bits(a16 if qmax == 32767 else a8))
                assert fallbacks > 0
            # a plane's own values rarely need the division
            assert _kernel_rint(plane, s, qmax)[1] < plane.size // 20


def test_wrappers_check_their_inputs_and_take_the_plain_versions_on_the_cpu():
    """On CPU tensors neither wrapper launches (the counters stay at 0), and
    each refuses what its kernel would not take."""
    fk.reset_launches()
    R0, R1 = torch.rand(5, 12, 20), torch.rand(5, 12, 20)
    zero = torch.zeros(12, 20)
    fk.warp_matrices_packed(R0, R1, fk.corner_scale(R1), zero, zero)
    assert fk.LAUNCHES["corner_scale"] == fk.LAUNCHES["warp_packed"] == 0
    with pytest.raises(ValueError, match="R1"):
        fk.corner_scale(torch.rand(4, 12, 20))
    with pytest.raises(TypeError, match="float32"):
        fk.corner_scale(R1.double())
    with pytest.raises(ValueError, match="scale"):
        fk.warp_matrices_packed(R0, R1, torch.ones(4), zero, zero)
    with pytest.raises(ValueError, match="R1"):
        fk.warp_matrices_packed(R0, R1[:, :-1], torch.ones(5), zero, zero)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fk.corner_scale(torch.empty(5, 12, 20, device="meta"))
