"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`card` that need an NVIDIA card (README.md names the command)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
