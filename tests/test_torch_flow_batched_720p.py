"""``benchmarks/flow_batched_720p``'s flow against cv2 itself, on all 8 of
its pairs (``make_frames(9, 720, 1280, seed=3)``, ``FarnebackConfig()``).

The card's machine has no cv2, so the benchmark takes its EPE against the
numpy model of cv2 (``oracle/np_farneback.calc_flow``).  Here, where cv2
imports, ``diagnostics/flow_accuracy`` runs the port's flow on the CPU (the
kernels' plain versions, which the CUDA kernels equal bit for bit): the
port is held to the benchmark's 0.1 px budget against
``cv2.calcOpticalFlowFarneback`` on every pair, and the two distances the
benchmark states (``PORT_VS_CV2_PX``, ``MODEL_VS_CV2_PX``) to what this run
reads, within their rounding.  Marked slow: ~1.5 min.
"""

import pytest

from datmo_using_optical_flow_tpu_torch.benchmarks import flow_batched_720p as fbm
from datmo_using_optical_flow_tpu_torch.diagnostics import flow_accuracy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def rows():
    rows = flow_accuracy.run("cpu")
    for r in rows:
        print(f"pair {r['pair']}: port vs cv2 {r['port_vs_cv2']['max']:.4e}, model vs cv2 "
              f"{r['model_vs_cv2']['max']:.4e}, port vs model {r['port_vs_model']['max']:.4e} px")
    assert len(rows) == fbm.BATCH
    return rows


def test_port_within_budget_of_cv2_on_every_pair(rows):
    worst = max(r["port_vs_cv2"]["max"] for r in rows)
    assert worst <= fbm.EPE_BUDGET_PX
    assert worst == pytest.approx(fbm.PORT_VS_CV2_PX, abs=5e-5)


def test_reference_distance_from_cv2_is_the_stated_one(rows):
    """The numpy model's own worst EPE against cv2 on these pairs, which
    the benchmark's record names beside its ``epe_max_px``."""
    assert max(r["model_vs_cv2"]["max"] for r in rows) == pytest.approx(fbm.MODEL_VS_CV2_PX,
                                                                         abs=5e-5)
