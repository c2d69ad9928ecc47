"""The benchmark's own tests: on the CPU at tiny sizes, and `cuda`-marked
ones that run the cells on a card (`python -m pytest gpbench/tests -m cuda`
on a machine with one) and skip elsewhere."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
