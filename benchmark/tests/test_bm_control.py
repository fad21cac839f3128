"""The control of `correct` on the card, at a size a test run holds:
the next lower precision in the program's place fails a number the
program passes (`control.py` reads the same at the cells' own sizes).

    python -m pytest -q benchmark/tests/test_bm_control.py   # on a card
"""

import pytest
import torch

from benchmark import control, harness
from bm_cells import small_cell

CELLS = ["yolov3-416.detect-int8.b64", "yolov3-416.detect-bf16.b64"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels run there)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    limits = harness.load_cell(cell)["check"]["limits"]
    with small_cell(cell, size=160, batch=2) as (tag, _):
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            r = control.readings(tag, seed, card)
            assert r["heads"] <= limits["heads"]
            assert r["dets"] <= limits["dets"]
            assert r["select"] <= limits["select"]
            assert (r["control_heads"] > limits["heads"]
                    or r["control_dets"] > limits["dets"]
                    or r["control_select"] > limits["select"])
