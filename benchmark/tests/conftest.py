"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

None needs the card: the harness runs here on tiny cells through its
plain paths (the port's kernels take their plain versions on CPU
tensors)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
