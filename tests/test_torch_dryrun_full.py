"""The port's dry run at the JAX dry run's full sizes on a 4-rank gloo group
of CPU processes: 200x200, the row-sharded flow at 1088x1920 (272 rows per
rank) and 1024 GMFA points per feed (~20 s of rank time on an 8-core host)."""

import pytest

from datmo_using_optical_flow_tpu_torch import dryrun
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.slow
def test_dryrun_at_full_size():
    report = dryrun.dryrun_multichip(4, "gloo", "cpu", reps=1, timeout=900)
    assert report["phase2"]["shape"] == [1088, 1920]
    assert report["phase2"]["rows_per_rank"] == 272
    assert report["phase2"]["max_epe"] < 1e-3
    assert report["phase3"]["points"] == 1024
    assert report["phase4"]["packed"]["velocity_err"] <= 5e-3
    assert report["phase4"]["exact"]["velocity_err"] <= 5e-3
