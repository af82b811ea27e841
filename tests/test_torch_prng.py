"""The port's threefry keys and draws against ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable=True``): keys, ``fold_in``, ``split`` and
float32 ``uniform`` and ``normal`` bit for bit (``normal`` through the port's
emulation of XLA's CPU ``log``, ``log1p`` and ``erf_inv``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SEEDS = (0, 1, 42, 77, -1, 2 ** 31 - 1)
SHAPES = ((1,), (7,), (300, 5), (3, 4, 5), (4097, 3))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32).astype(np.int64)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      np.asarray(jax.random.split(jk, num)).astype(np.int64))
    for data in (0, 1, 7, 123456, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      np.asarray(jax.random.fold_in(jk, data)).astype(np.int64))
    # chains, as the runner derives its per-frame keys and preprocess splits them
    jkr, jkd = jax.random.split(jax.random.fold_in(jk, 3))
    tkr, tkd = prng.split(prng.fold_in(tk, 3))
    np.testing.assert_array_equal(tkd.numpy(), np.asarray(jkd).astype(np.int64))


def test_seed_out_of_int32_raises():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bit_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = jax.random.uniform(jk, shape, dtype=jnp.float32)
    got = prng.uniform(tk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = jax.random.uniform(jk, shape, dtype=jnp.float32, minval=-2.5, maxval=4.0)
    np.testing.assert_array_equal(_bits(prng.uniform(tk, shape, -2.5, 4.0).numpy()), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bit_equal(seed):
    """XLA's CPU erf_inv, log and log1p are emulated with the multiply-adds
    XLA's CPU code contracts; the largest difference is printed."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in ((7,), (4097, 3), (81920, 3)):
        want = np.asarray(jax.random.normal(jk, shape, dtype=jnp.float32))
        got = prng.normal(tk, shape).numpy()
        ulp = np.abs(_bits(got).astype(np.int32).astype(np.int64)
                     - _bits(want).astype(np.int32).astype(np.int64))
        print(f"seed {seed} shape {shape}: normal max ulp {ulp.max()}, "
              f"share differing {np.mean(ulp > 0):.5f}")
        assert ulp.max() == 0


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    np.testing.assert_allclose(got, want, rtol=5e-7)


def _round_exact(x) -> np.float32:
    """The float32 nearest the rational ``x``, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.asarray(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``fma32(a, b, c)`` is the exact ``a * b + c`` rounded once to float32,
    with tensor and Python-constant operands (the draws' polynomials pass
    constants): random operands, and sums whose float64 rounding lands on a
    float32 tie that a second rounding would break the wrong way."""
    from fractions import Fraction

    from datmo_using_optical_flow_tpu_torch.utils.ordered import fma32

    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(3000).astype(np.float32) * np.float32(s)
               for s in (1.0, 1e-3, 1.0))
    # c = 1 + 2^-23 and a * b = 2^-24 - 2^-60: float64 rounds the sum to the
    # tie 1 + 2^-23 + 2^-24, which rounds to even (1 + 2^-22) instead of to c
    a = np.append(a, np.float32(1 - 2 ** -18))
    b = np.append(b, np.float32((1 + 2 ** -18) * 2 ** -24))
    c = np.append(c, np.float32(1 + 2 ** -23))
    want = np.array([_round_exact(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[-1] == np.float32(1 + 2 ** -23)
    assert np.float32(a[-1].astype(np.float64) * b[-1] + c[-1]) == np.float32(1 + 2 ** -22)
    for i in (0, 1, len(a) - 1):
        got = fma32(torch.from_numpy(a[[i]]), float(b[i]), float(c[i]))
        assert _bits(got.numpy())[0] == _bits(want[[i]])[0]
