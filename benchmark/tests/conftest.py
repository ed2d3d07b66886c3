"""Shared set-up of the benchmark's tests: the checkout's root on the path,
the ``card`` marker, and tiny copies of the cells for the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the cell's own sizes run on the H100")
    return torch.device("cuda", 0)
