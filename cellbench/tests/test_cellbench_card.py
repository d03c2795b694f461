"""On the card: one unit of each one-card cell's timed path, compared with
the reference at the cell's own size, and the lower-precision control
failing the same comparison. Skips without a card (the `card` fixture).

    python3 -m pytest -q cellbench/tests/test_cellbench_card.py
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from cellbench import calibrate

ROOT = Path(__file__).resolve().parents[2]
ONE_CARD = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_is_correct_and_its_control_is_not(card, cell):
    program, control = calibrate.readings(cell, 2**31 + 99, True)
    assert program["correct"] is True, program
    assert control["correct"] is False, control
