"""One torch thread for the port's CPU tests.

Tier-1 runs six pytest workers on the same cores; with torch's default of
one thread per core, the threads of several processes contend and the
plain versions' small ops ran many times slower.  A port test file
imports the fixture below, which then applies to every test in it."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
