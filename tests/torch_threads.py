"""A fixture for the port's test modules: run torch on one thread.

The kernels' plain PyTorch versions run thousands of tiny ops.  With
several pytest workers on one host, torch's intra-op thread pools only
contend with each other and with the other workers (a test module that
takes 2 s alone took 70 s under six workers).  Each ``test_torch_*``
module imports ``one_torch_thread``; being autouse, it applies to every
test of the importing module and restores the thread count after it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
