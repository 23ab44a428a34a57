"""The harness on the card (marked ``cuda``; skips without one): one short
run of each cell at its own size, correct, with the device numbers a
traced run reports.

    python -m pytest -m cuda wcxbench/tests/test_wcxbench_card.py
"""

import pytest
import torch

from wcxbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card_is_correct(card, cell):
    result = run.run_cell(cell, 2**32 + 17, 2.0, True)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, name
