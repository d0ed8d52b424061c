"""Tests of the benchmark. Most run on the CPU at tiny widths; those marked
``card`` need a CUDA card and skip without one (decided in a fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the program's kernels at its own size")
