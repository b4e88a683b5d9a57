"""Few threads for the CPU runs of the benchmark's tests."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)
