"""One torch intra-op thread for a port test module.

The tier-1 suite runs under pytest-xdist, 6 workers on a machine of 8
cores. Each worker's torch keeps a pool of as many intra-op threads as
the machine has cores, and XLA keeps its own; the port's tests run long
chains of small eager ops, each a parallel region whose threads wait on
one another, so with every worker's pools contending for the cores a port
test file runs many times slower than alone (on such a machine,
``pytest tests/test_torch_*.py -n 6 --dist loadfile`` took 632 s with
torch's default pool and 143 s with this fixture). A test module that
imports :func:`one_torch_thread` runs with one torch thread and puts the
count back when it ends; its arithmetic is the same ops in one thread,
and its tolerances stand as they are.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
