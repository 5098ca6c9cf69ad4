"""A fixture the port's CPU test files share: few torch threads.

The port's CPU tests run tiny shapes beside the JAX runtime's own threads,
and torch's default of one intra-op thread per core only contends there: on
an 8-core CPU host a tiny serve ran about 25x slower with 8 threads than
with 2, a tiny train step about 50x. A test module imports the fixture to
use it (it is autouse).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
