"""One intra-op torch thread for a whole test module.

A module that runs many small torch ops at the golden size gains nothing
from more threads, and under the tier's six test workers every process's
thread pool oversubscribes the shared cores: tests/test_torch_bench.py's
golden cut run took 222.5 s so and 8.5 s with one thread. A test module
takes it with `from _one_thread import one_thread  # noqa: F401`.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
