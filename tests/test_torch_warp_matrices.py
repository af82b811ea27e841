"""The port's K4 (``ops/flow_kernels.warp_matrices``) held to the JAX
package's Pallas ``warp_pallas.warp_matrices`` (interpret mode on the CPU, as
the JAX package's own tests run it), on the same numpy inputs.

Here each wrapper takes its plain PyTorch version; ``chip_smoke.py`` holds the
CUDA kernel to the same plain version on the card.  The JAX kernel takes R1 in
its padded window layout and only displacements inside that window, so the
flows here stay in range (``flow_in_range``), as the JAX tests keep them; the
port takes R1 unpadded and warps any displacement.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datmo_using_optical_flow_tpu.ops import warp_pallas
from datmo_using_optical_flow_tpu_torch.ops import flow_kernels as fk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _smooth_flow(h, w, amp=4.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = amp * np.sin(yy / 23) * np.cos(xx / 31)
    dy = 0.7 * amp * np.cos(yy / 19) * np.sin(xx / 37)
    return dx.astype(np.float32), dy.astype(np.float32)


def _step_flow(h, w):
    """Negative and integer displacements on two halves (the shift-mask edges)."""
    dx = np.full((h, w), -3.0, np.float32)
    dx[:, : w // 2] = 5.25
    return dx, np.full((h, w), 2.0, np.float32)


def _inputs(h, w, seed, flow):
    rng = np.random.default_rng(seed)
    R0, R1 = (rng.normal(size=(5, h, w)).astype(np.float32) for _ in range(2))
    dx, dy = flow(h, w)
    assert bool(warp_pallas.flow_in_range(jnp.asarray(dx), jnp.asarray(dy)))
    return R0, R1, dx, dy


def _jax_m(R0, R1, dx, dy):
    return np.asarray(warp_pallas.warp_matrices(jnp.asarray(R0), warp_pallas._pad_r1(
        jnp.asarray(R1)), jnp.asarray(dx), jnp.asarray(dy)))


def _port_m(R0, R1, dx, dy):
    return fk.warp_matrices(*(torch.as_tensor(a) for a in (R0, R1, dx, dy))).numpy()


@pytest.mark.parametrize("flow,seed", [(_smooth_flow, 0), (_step_flow, 4)],
                         ids=["smooth", "negative_and_integer"])
def test_warp_matrices_matches_pallas_kernel(flow, seed):
    """160x384 at atol 2e-4, as tests/test_flow_pallas.py holds the JAX kernel
    to the exact XLA path."""
    args = _inputs(160, 384, seed, flow)
    np.testing.assert_allclose(_port_m(*args), _jax_m(*args), atol=2e-4)


def test_warp_matrices_absolute_position_weights_wide():
    """1920 columns: the weights come from the absolute position floor(j+dx),
    so the error stays at ~1 ulp (< 1e-5) however far right the pixel."""
    rng = np.random.default_rng(11)
    R0, R1 = (rng.normal(size=(5, 160, 1920)).astype(np.float32) for _ in range(2))
    dx, dy = _smooth_flow(160, 1920, amp=3.7)
    err = np.abs(_port_m(R0, R1, dx, dy) - _jax_m(R0, R1, dx, dy)).max()
    assert err < 1e-5, err


@pytest.mark.parametrize("h,w,win,gaussian", [(160, 384, 15, False), (130, 384, 15, False),
                                              (132, 384, 7, True)])
def test_warp_matrices_then_blur_solve_equals_fused_iteration(h, w, win, gaussian):
    """K4 then K2 is K3, in the port (tests/test_flow_pallas.py:119-141 for the
    JAX kernels), including h % 32 < win // 2."""
    R0, R1, dx, dy = (torch.as_tensor(a) for a in _inputs(h, w, h, _smooth_flow))
    got = fk.blur_solve(fk.warp_matrices(R0, R1, dx, dy), win, gaussian)
    want = fk.fused_iteration(R0, R1, dx, dy, win, gaussian)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=2e-4)


def test_warp_matrices_reference_is_exact_update_matrices():
    """The plain version is the exact (unpacked) update_matrices, and the
    wrapper checks what the kernel takes."""
    from datmo_using_optical_flow_tpu_torch.ops import farneback as fb

    R0, R1, dx, dy = (torch.as_tensor(a) for a in _inputs(40, 48, 1, _smooth_flow))
    np.testing.assert_array_equal(fk.warp_matrices(R0, R1, dx, dy).numpy(),
                                  fb.update_matrices(R0, R1, dx, dy).numpy())
    with pytest.raises(ValueError, match="shape"):
        fk.warp_matrices(R0, R1[:, :-1], dx, dy)
    with pytest.raises(TypeError, match="float32"):
        fk.warp_matrices(R0, R1, dx.double(), dy)
