"""The traffic generator: every mix is fixed by its seed, and the seed
changes the rows, never the amount of work."""

import numpy as np
import pytest

from gpu_bench.harness import traffic as tr
from gpu_bench.harness.data import Objects
from gpu_bench.harness.spec import load_cell

SEEDS = (2 ** 31 + 5, 2 ** 33 + 9)


@pytest.mark.parametrize("name", ["ycbv-eval-b512", "lm-serve-frames"])
def test_rows_repeat_for_a_seed_and_differ_across_seeds(name):
    cfg = load_cell(name).config
    a, b = (Objects(cfg, SEEDS[0]).rows(SEEDS[0], 100, 3) for _ in range(2))
    c = Objects(cfg, SEEDS[1]).rows(SEEDS[1], 100, 3)
    for ra, rb, rc in zip(a, b, c):
        np.testing.assert_array_equal(ra["inp_feats"], rb["inp_feats"])
        assert not np.array_equal(ra["inp_feats"], rc["inp_feats"])


def test_rows_of_a_pool_all_differ():
    cfg = load_cell("ycbv-train-b32").config
    rows = Objects(cfg, SEEDS[0]).rows(SEEDS[0], 100, 8)
    keys = {r["inp_feats"].tobytes() for r in rows}
    assert len(keys) == 8


@pytest.mark.parametrize("seed", SEEDS)
def test_object_sizes_follow_the_configuration(seed):
    for name, (lo, hi) in (("ycbv-eval-b512", (0.02, 0.06)), ("lm-serve-frames", (0.05, 0.15))):
        objs = Objects(load_cell(name).config, seed)
        for cad in objs.cad:
            half = np.abs(cad).max(0)
            assert (half <= hi + 1e-6).all() and half.max() >= lo - 1e-6


def test_batch_order_cycles_the_pool_and_follows_the_seed():
    a = tr.batch_order(SEEDS[0], 4, 12)
    assert a == tr.batch_order(SEEDS[0], 4, 12)
    assert a != tr.batch_order(SEEDS[1], 4, 12)
    for k in range(3):
        assert sorted(a[4 * k:4 * k + 4]) == [0, 1, 2, 3]


def test_serve_frames_same_work_for_every_seed():
    traffic = load_cell("lm-serve-frames").traffic
    a = tr.frame_schedule(traffic, SEEDS[0], 30.0)
    b = tr.frame_schedule(traffic, SEEDS[0], 30.0)
    c = tr.frame_schedule(traffic, SEEDS[1], 30.0)
    np.testing.assert_array_equal(a.due_s, c.due_s)
    np.testing.assert_array_equal(a.sizes, c.sizes)
    assert all(np.array_equal(x, y) for x, y in zip(a.rows, b.rows))
    assert any(not np.array_equal(x, y) for x, y in zip(a.rows, c.rows))
    k = int(round(traffic["rate_per_s"] * 30.0))
    assert len(a.sizes) == k and a.due_s[0] == 0.0 and a.due_s[-1] < 30.0
    lo, hi = traffic["instances"]
    counts = np.bincount(a.sizes, minlength=hi + 1)[lo:]
    assert counts.max() - counts.min() <= 1


def test_serve_pad_count_by_hand():
    # sizes 1..8 once each, artifacts of 1 and 16 rows: 1 + 7 * 16 rows run
    assert tr.padded_rows(np.arange(1, 9), [1, 16]) == 113
    # past the largest artifact: chunks of 16, the rest in the smallest that fits
    assert tr.padded_rows([17], [1, 16]) == 17
    assert tr.padded_rows([18], [1, 16]) == 32
