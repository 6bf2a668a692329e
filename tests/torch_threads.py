"""The autouse fixture that runs a port test module's torch on one
intra-op thread. Import it into a test module to use it:

    from torch_threads import _one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU pages here are small: torch's intra-op threads do not speed
    these tests up (same wall time with 1 and 8), and under pytest-xdist
    they would take cores from the tests running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
