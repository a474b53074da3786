"""The knee of a serve cell: the highest frame rate its program sustains
without a growing backlog, found once when the cell is defined.

    python3 gpu_bench/sweep.py --workload <serve cell> --seed <n> --seconds 15 \
        --rates 10 15 20 25 30

One process, one set-up, then one open-loop window at each rate (the
cell's traffic otherwise unchanged). Prints a JSON line a rate: frames,
p50 / p95 / max latency, and the backlog's growth, the mean latency of the
window's last quarter of frames over that of its first quarter (about 1
when the queue is steady, growing with the window when it is not). The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpu_bench.harness import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    import numpy as np
    import torch

    from gpu_bench.harness.loops import make_loop
    from gpu_bench.harness.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if cell.traffic["loop"] != "serve":
        print(f"{cell.name} is not a serve cell", file=sys.stderr)
        return 2
    loop = make_loop(cell, args.seed, torch.device("cuda", 0))
    loop.setup()
    for rate in args.rates:
        res = loop.window(args.seconds, rate_per_s=rate)
        lat = np.asarray(res.latencies_s) * 1e3
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "cell": cell.name, "rate_per_s": rate, "frames": len(lat),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()), "backlog_growth": float(lat[-q:].mean() / lat[:q].mean()),
            "window_s": res.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
