"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds (16^3
grids, 64 points, a few rows), and one benchmark run's program side and
comparison without the timing: the tests drive the harness through these."""

from __future__ import annotations

import copy

from gpu_bench.harness import check
from gpu_bench.harness.loops import make_loop
from gpu_bench.harness.spec import load_cell

SEED = 2 ** 31 + 77  # larger than 32 signed bits, as the benchmark's seeds are


def small_cell(name: str):
    cell = copy.deepcopy(load_cell(name))
    model = cell.config["model"]
    model["voxel_num_limit"] = [16, 16, 16]
    model["unit_voxel_extent"] = [0.024] * 3 if cell.config_name == "ycbv" else [0.03] * 3
    model["n_inp"] = model["n_tmp"] = 64
    model["capacities"] = [64, 32, 16, 8]
    cell.config["assumed"]["model_points"] = 50
    t = cell.traffic
    if t["loop"] == "eval":
        t.update(batch=4, pool_batches=2)
    elif t["loop"] == "train":
        t.update(batch=4, pool_batches=5)
    else:
        t.update(pool_rows=16, instances=[1, 4], artifact_batches=[1, 4], checked_frames=4,
                 rate_per_s=16.0)
    return cell


def run_small(name: str, seed: int = SEED, seconds: float = 0.5, cell=None):
    """(loop, window result, compared numbers, correct) of one run of a
    small cell on the CPU."""
    cell = cell or small_cell(name)
    loop = make_loop(cell, seed, "cpu")
    loop.setup()
    res = loop.window(seconds)
    numbers = check.compare(loop, loop.program_outputs(), "cpu")
    return loop, res, numbers, check.judge(numbers, cell.limits)
