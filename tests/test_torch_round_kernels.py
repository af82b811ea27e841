"""The port's once-rounded float32 operations (K7, ``ops/round_kernels``) on
the CPU, where each wrapper takes its plain version: ``fma32`` with IEEE's
infinities and NaNs, ``sumsq_fma`` and ``norm_rn`` against exact rational
arithmetic rounded once per step, the Python-number operands and
broadcasting that the callers use, and the dispatch (no launch counted on the
CPU, any other device refused).  Tolerance: none, bits equal.

The JAX side of these values is held by ``test_torch_nn_fma.py`` and
``test_torch_sqrt_sites.py`` (each site against its compiled JAX function)
and the kernels by ``chip_smoke.py`` (each equal to its plain version on the
card).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu_torch.ops import round_kernels as rk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

INF = float("inf")


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _round_exact(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x``, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.asarray(c).view(np.int32)) & 1))


def test_fma32_keeps_infinities_and_nans():
    """IEEE's fma: an infinite product or addend gives that infinity, inf - inf
    and inf * 0 give NaN, and a finite product past float32's range rounds to
    inf.  Before the plain version took an infinite sum as it is, TwoSum's
    error (inf - inf) was NaN and the rounding-to-odd step turned every
    infinity into NaN."""
    a = torch.tensor([INF, 2.0, -INF, 1.0, INF, 1e30, 3.0, float("nan")])
    b = torch.tensor([2.0, INF, 1.0, 1.0, 0.0, 1e30, 2.0, 1.0])
    c = torch.tensor([1.0, -5.0, INF, INF, 1.0, 0.0, -INF, 1.0])
    got = rk.fma32(a, b, c).numpy()
    want = np.float32([INF, INF, np.nan, INF, np.nan, INF, -INF, np.nan])
    np.testing.assert_array_equal(got, want)
    assert np.isnan(rk.fma32(a, b, c, root=True).numpy()[[2, 4, 6, 7]]).all()
    assert rk.fma32(torch.tensor([INF]), 1.0, 1.0).item() == INF


def test_fma32_broadcasts_and_takes_numbers():
    """The rotation's ``fma32(y, r[:, 1], acc)`` shapes and the draws' number
    operands give what the full-size tensors give."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((50, 1)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((50, 3)).astype(np.float32))
    full = rk.fma32(y.expand(50, 3).contiguous(), r.expand(50, 3).contiguous(), acc)
    assert torch.equal(rk.fma32(y, r, acc), full)
    x = torch.from_numpy(rng.uniform(0, 1, 64).astype(np.float32))
    assert torch.equal(rk.fma32(x, 0.1, -2.5),
                       rk.fma32(x, torch.full_like(x, 0.1), torch.full_like(x, -2.5)))
    assert torch.equal(rk.fma32(x, x, 1.0, root=True), rk.sqrt_rn(rk.fma32(x, x, 1.0)))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sumsq_and_norm_round_each_step_once(k):
    """``sumsq_fma`` is ``fma(v[k-1], v[k-1], ... v[0] * v[0])`` with each step
    rounded once from the exact value; ``norm_rn`` is its correctly rounded
    root.  Rows of mixed scale, so that later terms round into the sum."""
    rng = np.random.default_rng(10 + k)
    v = (rng.standard_normal((400, k)) * rng.choice([1e-3, 1.0, 30.0], (400, k))
         ).astype(np.float32)
    want = []
    for row in v:
        acc = np.float32(row[0] * row[0])
        for x in row[1:]:
            acc = _round_exact(Fraction(float(x)) ** 2 + Fraction(float(acc)))
        want.append(acc)
    want = np.float32(want)
    got = rk.sumsq_fma(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    root = rk.norm_rn(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(root), _bits(np.float32(np.sqrt(want.astype(np.float64)))))
    # leading axes kept
    assert torch.equal(rk.sumsq_fma(torch.from_numpy(v).reshape(20, 20, k)),
                       torch.from_numpy(got).reshape(20, 20))


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    rk.reset_launches()
    v = torch.ones(8, 3)
    rk.fma32(v, v, v)
    rk.sumsq_fma(v)
    rk.norm_rn(v)
    assert rk.LAUNCHES == {"fma32": 0, "sumsq": 0}
    for fn, args in ((rk.fma32, (torch.ones(4, device="meta"), 1.0, 1.0)),
                     (rk.norm_rn, (torch.ones(4, 3, device="meta"),))):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            fn(*args)


def test_bits_equal_tells_signed_zeros_apart_and_takes_nan_as_nan():
    want = torch.tensor([0.0, float("nan"), 1.0, -float("inf")])
    assert rk.bits_equal(want.clone(), want)
    assert rk.bits_equal(torch.tensor([0.0, -float("nan"), 1.0, -float("inf")]), want)
    assert not rk.bits_equal(torch.tensor([-0.0, float("nan"), 1.0, -float("inf")]), want)
    assert not rk.bits_equal(torch.tensor([0.0, 0.0, 1.0, -float("inf")]), want)
    assert not rk.bits_equal(torch.tensor([0.0, float("nan"), float(np.nextafter(
        np.float32(1), np.float32(2))), -float("inf")]), want)
