"""Fixtures of the benchmark's tests.  Tests marked ``cuda`` take the
``card`` fixture, which skips them where no CUDA card is present; the
decision is made when the fixture runs, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
