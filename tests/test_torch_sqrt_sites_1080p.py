"""Pipeline A's velocity magnitude against the JAX package's compiled
frame-pair step at 1080x1920 (``tests/test_torch_sqrt_sites.py`` runs the
same check at 256x320 in Tier-1).  Tolerance: none, values equal."""

import numpy as np
import pytest

from test_torch_sqrt_sites import magnitude_case
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.slow
def test_magnitude_in_the_compiled_step_1080p():
    got, want = magnitude_case(1080, 1920)
    np.testing.assert_array_equal(got, want)
