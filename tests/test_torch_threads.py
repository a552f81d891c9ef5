"""One torch thread for the port's CPU test files.

Under pytest-xdist each worker is a process, and torch's intra-op pool
starts a thread per core in each of them: on a host of n cores, six
workers run 6n threads whose barriers spin, and the port's plain-PyTorch
tests slow down 10-100x (a case of 4 s alone took 440 s under six
workers). The port's heavier test files import one_torch_thread, a
module-scoped autouse fixture that runs the file on one thread and puts
the count back after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_file_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
