"""The port's K6 (``ops/probe_kernels.tiny``) held to the JAX package's
``tiny_pallas`` probe.

``tiny_pallas`` is defined inside ``main()`` of ``benchmarks/diag_icp_body.py``
and cannot be imported, so this test builds the same ``pl.pallas_call`` body
(``o_ref[...] = x_ref[...] + 1.0`` on an (8, 128) float32 block), run here in
interpret mode.  On the CPU the wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from datmo_using_optical_flow_tpu_torch.ops import probe_kernels as pk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _tiny_pallas(x):
    def _k(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    return pl.pallas_call(_k, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                          interpret=True)(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_matches_pallas_probe(seed):
    x = np.random.default_rng(seed).normal(size=(8, 128)).astype(np.float32) * 1e3
    want = np.asarray(_tiny_pallas(jnp.asarray(x)))
    pk.reset_launches()
    got = pk.tiny(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert pk.LAUNCHES == {"tiny": 0}  # the CPU takes the plain version


def test_tiny_checks_its_input():
    np.testing.assert_array_equal(pk.tiny(torch.zeros(3, 5)).numpy(), np.ones((3, 5)))
    with pytest.raises(TypeError, match="float32"):
        pk.tiny(torch.zeros(8, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        pk.tiny(torch.zeros(128, 8).T)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        pk.tiny(torch.zeros(8, 128, device="meta"))
