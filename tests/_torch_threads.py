"""One intra-op thread for the port's CPU tests (``tests/test_torch_*.py``
import ``one_thread``, an autouse module fixture).

The port's CPU tests run thousands of small torch ops, which one thread runs
faster than many; beside other test processes many spinning threads made them
up to ten times slower.  The fixture also limits the OpenMP and BLAS pools
(threadpoolctl; sklearn's t-SNE and numpy use them) and gives the previous
limits back at the module's end, so that the JAX package's tests that a worker
runs next keep theirs.  Processes a test starts (the torchrun ranks) set their
own."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)
