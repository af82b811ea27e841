"""One intra-op thread for the PyTorch port's CPU tests.

The Tier-1 run puts several pytest workers on the machine at once.  Left
alone, torch starts one thread per core in every worker, and the
oversubscribed threads slow every worker, JAX tests included: on an 8-core
host the whole run took 866 s this way against 305 s with one thread.  The
port's tests run small shapes, where one thread loses little.

Each ``tests/test_torch_*.py`` that computes with torch imports the fixture,
which pytest then applies to the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
