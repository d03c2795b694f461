"""Fixtures of the benchmark's own tests: the CPU rehearsal's tiny size and
the card, decided inside a fixture (never at import)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = Path(__file__).resolve().parent / "tiny.json"


@pytest.fixture
def tiny() -> str:
    return str(TINY)


@pytest.fixture
def card():
    """Skip unless a CUDA device is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
