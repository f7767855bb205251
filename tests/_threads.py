"""One intra-op torch thread for a test module: the suite runs six
workers on one machine, and a worker whose torch spreads over every core
spins those cores against the other five. Use as a module-scoped autouse
fixture: ``_one_thread = pytest.fixture(autouse=True,
scope="module")(one_thread)``. Not a test module (no ``test_``
prefix)."""
import torch


def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
