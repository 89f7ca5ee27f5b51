"""On the card: the tiny cells through the harness, sound and broken. Skips
where there is no card."""
import time

import pytest
import torch

from mcmcbench.lib import harness
from mcmcbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["lm", "lr"])
def test_tiny_cells_on_the_card(card, which):
    cell = tiny.lm_cell() if which == "lm" else tiny.lr_cell()
    out = harness.run_cell(cell, 2 ** 31 + 31, 0.5, True, card, time.monotonic())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
