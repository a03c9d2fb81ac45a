"""The port test files' shared module fixture: torch on two intra-op
threads. Tier-1 runs six workers on the machine's cores, and a worker whose
torch spins on all of them ran the port's tests at 5-35x their one-process
time. A port test file takes it with
``from test_torch_threads import _two_threads  # noqa: F401``; pytest
registers a fixture that a module imports as that module's own."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op torch threads for the importing module's tests, the
    caller's count restored after its last one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_two_threads_inside_the_module():
    assert torch.get_num_threads() == 2
