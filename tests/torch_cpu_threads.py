"""One PyTorch thread for the port's CPU tests.

The tests run under pytest-xdist: several worker processes share the
machine's cores. PyTorch's CPU operators each spread over every core,
so beside the other workers they contend for them and run tens of times
slower (the port's CPU path is many small operators). A test module
imports this fixture to run its tests with one PyTorch thread; the
setting is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
