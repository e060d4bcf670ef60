"""A module-scoped fixture for the port's CPU tests whose PyTorch ops are
small: a few intra-op threads run them as fast as all cores do, and do not
starve the other test processes running beside them (tier-1 runs one file
per worker). Import `few_torch_threads` into a test module to apply it."""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)
