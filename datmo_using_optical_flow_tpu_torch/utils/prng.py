"""Threefry-2x32 keys and draws, bit-equal to ``jax.random``.

The port draws the same random numbers as the JAX package does under
``jax_threefry_partitionable=True`` (the default of the jax release the
package is held to): a key is two uint32 words, :func:`split` and
:func:`random_bits` hash a 64-bit iota of the output shape (high word, low
word) with the key, :func:`fold_in` hashes ``(0, data)``.  Unsigned 32-bit
arithmetic runs on int64 tensors masked to 32 bits (torch's uint32 support
is partial), on the key's device, with constants passed as Python scalars:
drawing on the card needs no host round trip.

* :func:`uniform` is bit-equal to ``jax.random.uniform`` in float32.
* :func:`normal` draws ``uniform`` on ``(nextafter(-1, 0), 1)`` and returns
  ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv`` polynomial
  (:func:`erf_inv`; ``torch.erfinv`` is another approximation), over XLA's
  CPU ``log1p`` and ``log`` approximations, with the multiply-adds XLA's CPU
  code contracts rounded once (``ordered.fma32``), so the draws equal JAX's
  bit for bit; :func:`normal_fma` is a scaled draw added to a tensor as a
  jitted JAX function computes it (the densifier's jitter).
* :func:`randint` is bit-equal to ``jax.random.randint`` in int32.

Everything is elementwise +, *, /, comparisons, bit operations and
float64 roundings, correctly rounded on both devices, so the card draws
what the CPU draws.
"""

from __future__ import annotations

import numpy as np
import torch

from datmo_using_optical_flow_tpu_torch.utils.ordered import fma32, sqrt_rn

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``; int64 tensors holding uint32 values, the
    key's broadcast against the counters'."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds: ``[0, seed mod 2^32]``
    as a (2,) int64 tensor."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                      torch.full((1,), seed & _MASK, dtype=torch.int64, device=device)])


def _iota_2x32(shape: tuple[int, ...], device) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat index of every element of ``shape`` as (high, low) words."""
    n = 1
    for d in shape:
        n *= d
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return iota >> 32, iota & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``."""
    word = torch.full((1,), data & _MASK, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(word), word)
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding uint32)."""
    hi, lo = _iota_2x32(tuple(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa bits with exponent 0, minus 1: float32 in [0, 1)."""
    word = (bits >> 9) | 0x3F800000
    as_int32 = torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)
    return as_int32.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for bit."""
    floats = _bits_to_unit(random_bits(key, shape))
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(fma32(floats, float(hi - lo), float(lo)), min=float(lo))


# Cephes' float32 log, as XLA's CPU backend approximates it: mantissa m in
# [sqrt(1/2), sqrt(2)) - 1 and exponent e, then a degree-8 polynomial
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
# Cephes' rational log1p for |x| < sqrt(2) - 1, highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_MIN_NORMAL = 1.1754943508222875e-38


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 log of x > 0 by XLA's CPU polynomial."""
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < 0.7071067811865476
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = fma32(fma32(m, p[0], p[1]), m, p[2])
    y1 = fma32(fma32(m, p[3], p[4]), m, p[5])
    y2 = fma32(fma32(m, p[6], p[7]), m, p[8])
    y = fma32(fma32(fma32(y, x3, y1), x3, y2), x3, e * -2.12194440e-4)
    m = (m - x2 * 0.5) + y
    return m + e * 0.693359375


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p by XLA's CPU code: Cephes' rational form near 0,
    ``log(1 + x)`` elsewhere."""
    def poly(coefs):
        r = torch.zeros_like(x)
        for c in coefs:
            r = fma32(r, x, c)
        return r

    x2 = x * x
    small = x + (x2 * -0.5 + (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(torch.abs(x) < 0.41421356237309504880, small, _log(x + 1.0))


# XLA's float32 erf_inv (Giles' single-precision polynomial), coefficients in
# Horner order for w < 5 and for w >= 5
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` by XLA's polynomial: ``w = -log1p(-x * x)``, a
    degree-8 polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times x;
    +-inf at +-1."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)

    def coef(i: int) -> torch.Tensor:
        return torch.where(lt, float(np.float32(_ERF_INV_LT5[i])),
                           float(np.float32(_ERF_INV_GE5[i])))

    p = coef(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = fma32(p, w, coef(i))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _rem(x, span: int):
    """XLA's unsigned remainder: ``x`` itself when ``span`` is 0."""
    return x % span if span else x


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 values, in halves: no int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``, bit for bit.

    Two 32-bit draws from the halves of ``split(key)``, ``hi`` and ``lo``,
    reduced modulo ``span = maxval - minval`` (uint32) as ``((hi % span) *
    m + lo % span) % span`` in wrapping uint32 arithmetic, where ``m =
    (2^16 % span)^2 % span`` is ``2^32 mod span`` only up to spans of 2^16:
    above, JAX's uint32 square wraps to 0 and so does ``m`` here.  The
    bounds are clipped to int32; ``maxval <= minval`` gives ``minval``, and a
    ``maxval`` above the int32 range widens the span by one, as JAX's does.
    """
    out_of_range = maxval > _INT32_MAX
    lo_v = min(max(minval, _INT32_MIN), _INT32_MAX)
    hi_v = min(max(maxval, _INT32_MIN), _INT32_MAX)
    span = (hi_v - lo_v) & _MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _MASK
    multiplier = _rem((_rem(2 ** 16, span) ** 2) & _MASK, span)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    offset = (_mul32(_rem(higher, span), multiplier) + _rem(lower, span)) & _MASK
    word = (_rem(offset, span) + (lo_v & _MASK)) & _MASK
    return torch.where(word > _INT32_MAX, word - 2 ** 32, word).to(torch.int32)


_NORMAL_LO = -0.9999999403953552  # nextafter(-1, 0) in float32
_SQRT2 = 1.4142135381698608  # float32(sqrt(2))


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, bit for bit."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erf_inv(u) * _SQRT2


def normal_fma(key: torch.Tensor, addend: torch.Tensor, scale: float) -> torch.Tensor:
    """``addend + normal(key, addend.shape) * scale`` as XLA compiles it
    inside a jitted function: ``sqrt(2) * scale`` folded into one float32
    constant, and its product with ``erf_inv(u)`` added to ``addend`` in one
    rounding (``ordered.fma32``)."""
    u = uniform(key, tuple(addend.shape), _NORMAL_LO, 1.0)
    return fma32(erf_inv(u), float(np.float32(_SQRT2) * np.float32(scale)), addend)
