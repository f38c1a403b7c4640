"""The port's test files run torch on one intra-op thread. This helper
imports no JAX, so the card-marked files can use it too."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_a_module():
    """One intra-op torch thread for the whole module, its module-scoped
    fixtures included (autouse where imported): the tier-1 run takes the
    test files in 6 processes at once, and with every process's pool on
    every core the small CPU kernels of these tests ran 3-30x slower than
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
