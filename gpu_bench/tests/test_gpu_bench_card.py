"""On the card: each cell's harness at a reduced batch (the configuration's
full widths) comes out correct, and its control, the reference in TF32 in
the program's place, fails the cell's limits. Skipped without a card."""

import copy

import pytest

from gpu_bench.calibrate import control_numbers
from gpu_bench.harness import check
from gpu_bench.harness.loops import make_loop
from gpu_bench.harness.spec import load_cell

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102)
CELLS = ["ycbv-eval-b512", "ycbv-train-b32", "lm-serve-frames"]


def reduced(name: str):
    """The cell at its widths with fewer rows: a batch of 32 to evaluate, 8
    to train, 4 frames a second to serve."""
    cell = copy.deepcopy(load_cell(name))
    t = cell.traffic
    if t["loop"] == "eval":
        t.update(batch=32)
    elif t["loop"] == "train":
        t.update(batch=8, pool_batches=5)
    else:
        t.update(rate_per_s=4.0, checked_frames=8)
    return cell


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_program_correct_and_control_not(name, seed, card):
    cell = reduced(name)
    loop = make_loop(cell, seed, card)
    loop.setup()
    loop.window(2.0)
    numbers = check.compare(loop, loop.program_outputs(), card)
    assert check.judge(numbers, cell.limits), numbers
    loop = make_loop(cell, seed, card)
    loop.setup()
    for label, got in control_numbers(loop, card, 2.0).items():
        assert not check.judge(got, cell.limits), (label, got)
