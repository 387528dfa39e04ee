"""Tests of the benchmark (benchmark/), run on the CPU:

    python -m pytest benchmark/tests -q

from the root of the repository.  They import the harness and the
reference from benchmark/ and the port from the root.  Tests marked
`gpu` need a CUDA card and skip inside the test without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
