"""The benchmark's own tests: the checkout's root on the import path and
the ``cuda`` marker for tests that need a card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


@pytest.fixture
def bench():
    from cardbench import harness

    return harness.load_benchmark()


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda")
