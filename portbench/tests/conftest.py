"""Tests of the benchmark itself. Those marked ``card`` need an NVIDIA
card and skip without one (decided inside the test, never at import):

    python3 -m pytest portbench/tests -q            # on the CPU
    python3 -m pytest portbench/tests -q -m card    # on the card
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)
