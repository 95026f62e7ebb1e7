"""Tests of the benchmark harness. They run on the CPU at small sizes; the
ones marked `card` need an H100 and skip without one (`python3 -m pytest
perfbench/tests -m card` on the card)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the harness measures only on the card")
    return torch.device("cuda")
