"""A tiny cell run whole on the card, traced: correct, with every per-layer metric read and each
share of a roofline at most 100%.

    python -m pytest --noconftest portbench/tests/test_portbench_card.py -m cuda
"""
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import CELLS, make_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_on_the_card_is_correct_and_traced(tmp_path, card, cell):
    root = make_root(tmp_path, classes=20, images=16, height=256, width=512)
    result = harness.run(root, cell, 2**31 + 41, 0.5, True, card, time.time(), log=lambda m: None)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in harness.cells(root)[cell].metrics("per_layer")}
    for name, metric in result["metrics"].items():
        if "roofline" in name:
            assert 0 < metric["value"] <= 100, (name, metric)
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]
