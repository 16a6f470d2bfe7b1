"""The benchmark's tests: its harness on the CPU at small sizes, and (marked
``card``) what only a CUDA card can run, which skips here.

    python -m pytest benchmark/tests -q                 # the CPU tests
    python -m pytest benchmark/tests -q -m card         # on a card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is found (decided at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
