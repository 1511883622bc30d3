"""Tests of the benchmark.  ``python -m pytest portbench/tests -q`` runs
them on the CPU; the tests marked ``cuda`` skip there, and run on a
machine with a card with ``python -m pytest portbench/tests -m cuda -q``.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    """PyTorch on one thread for the test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
