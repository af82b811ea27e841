"""The batched flow and the numpy model of cv2's Farnebäck flow.

``ops/farneback.farneback_flow_batched`` against the JAX package's on the
same pairs (B = 2, a two-level pyramid), against the per-pair flow and
against cv2; ``oracle/np_farneback.calc_flow`` (the port's verbatim copy,
the EPE reference of ``benchmarks/flow_batched_720p``) bit-equal to the JAX
package's numpy oracle.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_frames
from datmo_using_optical_flow_tpu.oracle import np_farneback as j_npfb
from datmo_using_optical_flow_tpu.ops import farneback as jfb
from datmo_using_optical_flow_tpu_torch.benchmarks import flow_batched_720p
from datmo_using_optical_flow_tpu_torch.config import FarnebackConfig
from datmo_using_optical_flow_tpu_torch.ops import farneback as fb
from datmo_using_optical_flow_tpu_torch.oracle import np_farneback as t_npfb
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 144, 192  # levels 43x58 and 144x192, both below K3's 128x256


@pytest.fixture(scope="module")
def frames():
    return make_frames(3, H, W, seed=3).astype(np.float32)


def test_two_levels():
    assert [s[2:] for s in t_npfb.level_sizes(H, W, 0.3, 5)] == [(43, 58), (144, 192)]


@pytest.mark.parametrize("fast_warp", [False, True])
def test_batched_matches_jax(frames, fast_warp):
    """The JAX package's batched flow on its XLA path (``use_pallas=False``),
    exact or packed warp on both levels, as the port's flow below 128x256
    with the same ``fast_warp``: flow atol 1e-4 px."""
    cfg = FarnebackConfig()
    want = np.asarray(jfb.farneback_flow_batched(jnp.asarray(frames[:2]),
                                                 jnp.asarray(frames[1:]),
                                                 use_pallas=False, fast_warp=fast_warp))
    got = fb.farneback_flow_batched(torch.as_tensor(frames[:2]), torch.as_tensor(frames[1:]),
                                    cfg, fast_warp)
    assert got.shape == (2, H, W, 2) and np.abs(want).max() > 0.5  # the scene moves
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_batched_equals_per_pair_and_cv2(frames):
    """Each entry is the pair's own flow bit for bit, and within 0.1 px of
    cv2 (the benchmark's EPE budget)."""
    cfg = FarnebackConfig()
    got = fb.farneback_flow_batched(torch.as_tensor(frames[:2]), torch.as_tensor(frames[1:]),
                                    cfg)
    for i in range(2):
        one = fb.farneback_flow(torch.as_tensor(frames[i]), torch.as_tensor(frames[i + 1]), cfg)
        assert torch.equal(got[i], one)
        ref = cv2.calcOpticalFlowFarneback(frames[i], frames[i + 1], None, cfg.pyr_scale,
                                           cfg.levels, cfg.winsize, cfg.iterations, cfg.poly_n,
                                           cfg.poly_sigma, 0)
        assert np.linalg.norm(got[i].numpy() - ref, axis=-1).max() < 0.1
    with pytest.raises(ValueError, match="batches"):
        fb.farneback_flow_batched(torch.as_tensor(frames[0]), torch.as_tensor(frames[1]), cfg)


@pytest.mark.parametrize("gaussian", [False, True])
def test_calc_flow_copy_bit_equal(frames, gaussian):
    """The port's copy of the numpy model equals the JAX package's bit for
    bit (the copy is verbatim: ``test_torch_boundary.py``)."""
    got = t_npfb.calc_flow(frames[0], frames[1], gaussian=gaussian)
    want = j_npfb.calc_flow(frames[0], frames[1], gaussian=gaussian)
    assert got.dtype == want.dtype and got.shape == (H, W, 2)
    np.testing.assert_array_equal(got, want)


def test_benchmark_epe_helper(frames):
    """``flow_batched_720p.oracle_epe_max`` at this size: the port's flows
    within the 0.1 px budget of the numpy model; the benchmark refuses the
    CPU."""
    cfg = FarnebackConfig()
    flows = fb.farneback_flow_batched(torch.as_tensor(frames[:2]), torch.as_tensor(frames[1:]),
                                      cfg).numpy()
    epe = flow_batched_720p.oracle_epe_max(frames, flows, cfg, 2)
    assert 0.0 < epe < flow_batched_720p.EPE_BUDGET_PX
    with pytest.raises(RuntimeError, match="CUDA"):
        flow_batched_720p.run("cpu")


def test_flow_accuracy_diagnostic():
    """``diagnostics/flow_accuracy`` at this size on the CPU: each pair's
    three EPEs, the port within the benchmark's 0.1 px of cv2 (both levels
    take the packed warp at this size)."""
    from datmo_using_optical_flow_tpu_torch.diagnostics import flow_accuracy

    rows = flow_accuracy.run("cpu", pairs=2, h=H, w=W)
    assert [r["pair"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == {"pair", "port_vs_model", "port_vs_cv2", "model_vs_cv2"}
        assert r["port_vs_cv2"]["max"] < flow_batched_720p.EPE_BUDGET_PX
        assert r["port_vs_model"]["interior_max"] <= r["port_vs_model"]["max"]
