"""One PyTorch intra-op thread for a test module of the port.

The suite runs several test processes side by side on the machine's
cores, and PyTorch's default intra-op pool (a thread a core) in each of
them oversubscribes the CPU: the tiny models of the port's tests are
thousands of small operations, which one thread runs fastest. A test
module imports the autouse fixture::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with one_thread():
        yield
