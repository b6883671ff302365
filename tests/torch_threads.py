"""The port's CPU tests on one intra-op torch thread: its plain versions
are many small torch ops, and the test workers share the cores. A test
module takes it with

    from torch_threads import _one_thread  # noqa: F401

(an autouse fixture of module scope; the thread count is restored after
the module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
