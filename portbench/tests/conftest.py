"""The benchmark's own tests (run with ``python -m pytest portbench/tests``).

Tests that need a CUDA card are marked ``cuda`` and decide inside the test
whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none here)")
    return torch.device("cuda")
