"""CPU tests of the benchmark (run from the checkout root:
``python -m pytest benchmark/tests -q``); tests marked ``chip`` need a
CUDA card and skip without one (on the card:
``python -m pytest benchmark/tests -q -m chip``)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def repo():
    return REPO
