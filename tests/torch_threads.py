"""One torch thread while a test module runs (import the fixture into the
module: ``from tests.torch_threads import one_torch_thread``).

The test suite runs in six pytest workers on eight cores; each worker's
torch would otherwise keep a pool of one thread per core, and the port's many
small CPU ops then wait on each other's threads (a 1.5 s test of the flow-CRF
segmentation took 375 s that way)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
