"""pytest settings of the benchmark's own tests (``ghs_bench/tests``).

Run them from the checkout's root: ``python -m pytest ghs_bench/tests -q``.
Tests marked ``card`` need an NVIDIA card and skip without one; the
``card`` fixture decides, when the test runs.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is visible")
    return "cuda"
