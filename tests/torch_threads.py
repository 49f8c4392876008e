"""One torch intra-op thread for the port's parity tests.

The tier-1 run puts six pytest workers on the machine's cores. torch's
CPU ops fan each small tile op out to a pool of one thread per core, so
six pools oversubscribe the cores and every op waits at the pool's
barrier for descheduled threads: on an 8-core CPU, beside five busy
processes, two z dd driver tests took 102 s that way and 1.5 s on one
thread. The port's tests run thousands of such ops on small tiles,
where one thread loses nothing.

A test module imports :func:`one_torch_thread`; being module-scoped and
autouse, it holds for that module's tests and restores the pool size
after them, so the JAX package's tests in the same worker are
untouched.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
