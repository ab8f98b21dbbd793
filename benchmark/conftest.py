"""pytest settings of the benchmark's own tests (``benchmark/tests``).

The tests import the benchmark's modules as ``run.py`` does, with the
benchmark's folder and the checkout's root on ``sys.path``.  Tests that
need an NVIDIA card carry the ``card`` marker and the ``card`` fixture,
which decides at run time whether there is one and skips where there is
none.
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip (benchmark/README.md)")
    return torch.device("cuda", 0)
