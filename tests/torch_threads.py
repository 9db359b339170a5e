"""One torch thread per test process.

The suite runs in several worker processes on one machine's cores; each
torch process would otherwise start one OpenMP thread per core, and the
workers' spinning threads stall each other (the port's receiver tests ran
8x slower in six workers than with one thread each).  Test modules of the
port import :func:`one_torch_thread`, an autouse fixture.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
