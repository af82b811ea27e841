"""The port's ``prng.randint`` against ``jax.random.randint`` (jax 0.9.0,
partitionable threefry, int32), bit for bit.

``randint`` draws GMFA's new track ids (``randint(key, (max_clusters,), 0,
100000)``, the JAX package's ``models/gmfa.py:622``).  Its spans are held
over 200 keys each: 100000 (not a power of two, and above 2^16, where JAX's
``2^32 mod span`` multiplier wraps to 0 in uint32), 2^16, 7 and 1, plus the
branches of JAX's ``_randint``: ``maxval <= minval`` (always ``minval``), a
negative ``minval``, the full int32 range (a span of 2^32 - 1), and a
``maxval`` above the int32 range (JAX widens the span by one, wrapping it
to 0 at the full range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

N_KEYS = 200


def _keys(seed: int):
    """N_KEYS JAX keys and the same keys as the port's int64 tensors."""
    jkeys = jax.random.split(jax.random.PRNGKey(seed), N_KEYS)
    return list(zip(jkeys, torch.as_tensor(np.asarray(jkeys).astype(np.int64))))


@pytest.mark.parametrize("span", [100000, 2 ** 16, 7, 1])
def test_randint_spans_bit_equal(span):
    draw = jax.jit(lambda k: jax.random.randint(k, (8,), 0, span, dtype=jnp.int32))
    for jk, tk in _keys(span % 1000):
        want = np.asarray(draw(jk))
        got = prng.randint(tk, (8,), 0, span)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 <= int(got.min()) and int(got.max()) < span


@pytest.mark.parametrize("minval, maxval", [
    (5, 5), (5, 2),                   # maxval <= minval: minval
    (-5, 3),                          # negative minval
    (-2 ** 31, 2 ** 31 - 1),          # a span of 2^32 - 1
    (0, 2 ** 32 - 1),                 # maxval above int32: the span grows by one
    (-2 ** 31, 2 ** 32 - 1),          # ... and wraps to 0: the low draw alone
])
def test_randint_branches_bit_equal(minval, maxval):
    # a maxval above the int32 range reaches JAX's out-of-range branch as a uint32
    jmax = jnp.uint32(maxval) if maxval > 2 ** 31 - 1 else maxval
    draw = jax.jit(lambda k: jax.random.randint(k, (3, 5), minval, jmax, dtype=jnp.int32))
    for jk, tk in _keys(7):
        np.testing.assert_array_equal(prng.randint(tk, (3, 5), minval, maxval).numpy(),
                                      np.asarray(draw(jk)))
    if maxval <= minval:
        assert int(prng.randint(tk, (3, 5), minval, maxval).unique()) == minval
