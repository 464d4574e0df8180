"""A fixture for the port's test modules: run torch on one thread.

The kernels' plain PyTorch versions run thousands of tiny ops.  With
several pytest workers on one host, torch's intra-op thread pools only
contend with each other and with the other workers (a test module that
takes 2 s alone took 70 s under six workers).  Each ``test_torch_*``
module imports ``one_torch_thread``; being autouse, it applies to every
test of the importing module and restores the thread count after it.

``few_cores`` does the same for the shard processes of a pod test:
each serves on the C++ core with ``os.cpu_count()`` threads, so a pod of
four takes every core of the host from the other workers unless the
test pins itself, and the children it starts, to a few."""

import contextlib
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def few_cores(n: int = 3):
    """Pin the calling thread to at most ``n`` of its CPUs, and with it
    every process and thread it starts meanwhile (they inherit the
    mask); restore the mask on exit."""
    allowed = os.sched_getaffinity(0)
    os.sched_setaffinity(0, sorted(allowed)[-n:])
    try:
        yield
    finally:
        os.sched_setaffinity(0, allowed)
