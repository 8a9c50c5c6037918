"""One PyTorch CPU thread for a test module of the port.

The tier-1 run puts several pytest workers on one machine.  Each worker's
PyTorch would start an OpenMP thread per core, and the workers' spinning
threads then slow the port's CPU tests many times over.  A module that
imports `one_torch_thread` runs its tests on one thread and gives the
worker its old thread count back at the end.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
