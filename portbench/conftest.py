"""The benchmark's own tests: ``python -m pytest portbench -q``.

Tests marked ``card`` run the benchmark at a cell's size on an NVIDIA
card; whether one is there is decided inside each such test (the ``card``
fixture), which skips without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
