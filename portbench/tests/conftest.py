"""The benchmark's own tests: CPU at small sizes, and ``cuda`` tests that
need the card and skip without one. Run them from the repository root:

    python -m pytest portbench/tests -q
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU "
        "mode); skips without one")


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
