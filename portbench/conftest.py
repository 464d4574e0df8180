"""Test settings of the benchmark's own tests (``portbench/tests``).

Tests that need the card carry the ``card`` marker and decide inside a
fixture whether there is one, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips elsewhere (run on the "
        "card with: python3 -m pytest portbench/tests -m card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this host has none")
    return torch.device("cuda")
