"""The one generator of every traffic mix: it reads traffic/<name>.json.

Three loops, named by the file's "loop":

  eval   closed loop of Evaluator.evaluate over batches of "batch" rows: a
         pool of "pool_batches" distinct batches, cycled, each cycle in an
         order drawn from the seed.
  train  closed loop of Solver.train_epoch over batches of "batch" rows from
         a pool of "pool_batches" distinct batches, cycled likewise; the
         first "setup_steps" batches are the set-up's steps, all distinct.
  serve  open loop: frames of "instances" = [lo, hi] rows arrive at
         "rate_per_s". Every seed gets the same frame sizes (each size of
         lo..hi equally often) and gaps (the quantiles of an exponential
         distribution at that rate, scaled to fill the window) in one fixed
         succession; the rows come from a pool of "pool_rows" distinct
         rows, drawn from the seed.

The seed changes which rows (and, in a closed loop, in what order), never
how much work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

LOOPS = ("eval", "train", "serve")


def batch_order(seed: int, pool: int, count: int) -> List[int]:
    """`count` pool indices: whole cycles of the pool, each a permutation
    drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    out: List[int] = []
    while len(out) < count:
        out.extend(int(i) for i in rng.permutation(pool))
    return out[:count]


@dataclass
class Frames:
    """An open-loop schedule: frame k is due at `due_s[k]` seconds after the
    window opens and holds the pool rows `rows[k]`."""

    due_s: np.ndarray
    rows: List[np.ndarray]

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(r) for r in self.rows])


def frame_schedule(traffic: Dict, seed: int, seconds: float,
                   rate_per_s: float = None) -> Frames:
    """The frames of a `seconds` window of a serve mix (rate_per_s
    overrides the mix's rate, for a sweep).

    The sizes and gaps are one fixed succession: each size of the mix's
    range equally often and the quantiles of an exponential distribution at
    the rate, scaled to fill the window, shuffled once by a constant. The
    seed draws the rows of each frame: every seed offers the same frames
    and bursts at the same times, so a tail over a window's few hundred
    frames does not move with the seed's arrival order."""
    rate = float(traffic["rate_per_s"] if rate_per_s is None else rate_per_s)
    lo, hi = (int(v) for v in traffic["instances"])
    k = max(1, int(round(rate * seconds)))
    fixed = np.random.default_rng(11)
    sizes = lo + np.arange(k) % (hi - lo + 1)
    q = (np.arange(k) + 0.5) / k
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    sizes = sizes[fixed.permutation(k)]
    gaps = gaps[fixed.permutation(k)]
    # the first frame is due when the window opens
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    pool = int(traffic["pool_rows"])
    rng = np.random.default_rng([int(seed), 11])
    rows = [rng.choice(pool, int(n), replace=False) for n in sizes]
    return Frames(due, rows)


def padded_rows(sizes: np.ndarray, fixed_sizes: List[int]) -> int:
    """Rows a bundle of fixed-batch artifacts runs for frames of `sizes`:
    the smallest artifact at least n, chunks of the largest beyond it
    (serving.py::BundleServer's policy)."""
    fixed = sorted(int(s) for s in fixed_sizes)
    total = 0
    for n in sizes:
        rem = int(n)
        while rem > 0:
            fit = [s for s in fixed if s >= rem]
            b = fit[0] if fit else fixed[-1]
            total += b
            rem -= min(rem, b)
    return total
