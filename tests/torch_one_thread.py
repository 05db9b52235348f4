"""A fixture that runs torch on one CPU thread for the duration of a test.

The port's parity tests hold torch's CPU results against JAX's to a few ulp.
With several threads, torch's CPU kernels did not reproduce their results
across processes: on the same inputs the plain blend moved by up to 2e-4 of
its largest entry in some processes, forward and backward, and only when run
multi-threaded. On one thread every run gave the same, tight, result. The
test modules use it with
``pytestmark = pytest.mark.usefixtures("one_torch_thread")``.
"""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
