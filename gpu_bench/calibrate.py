"""The readings that each cell's limits (limits/<cell>.json) are set from.

    python3 gpu_bench/calibrate.py --workload <cell> --seconds 3 \
        --seeds 1 2 3 ... --control-seeds 4 5 6

For each of --seeds, one run of the cell's timed path at the cell's own
size (a short window), compared with the reference as a benchmark run
compares it: the lower readings. For each of --control-seeds, the control:
the reference computed with TF32 on (the precision below the
configuration's float32) put in the program's place, compared with the
float32 reference; for a training cell also the fault "half of the batch
left out, the loss a mean over the rest", planted in the reference. Prints
one JSON line a reading. The benchmark's runs do not run this.
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


def half_batch(batch):
    """The first half of a batch's rows: the fault that drops the rest."""
    import torch

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x[: x.shape[0] // 2] if isinstance(x, torch.Tensor) else x
    return cut(batch)


def control_numbers(loop, device, seconds: float):
    """{reading name: numbers} of the control (and, for training, the
    planted faults) on this loop's inputs."""
    import numpy as np

    from gpu_bench.harness import check
    from gpu_bench.reference import model as ref
    from gpu_bench.reference import train as ref_train

    cfg = loop.cell.config
    for attr in ("solver", "evaluator", "model"):  # the program's state
        if hasattr(loop, attr):
            delattr(loop, attr)
    if loop.kind == "train":
        names = [n for n in loop.names]
        batches = check.checked_batches(loop, device)
        ref.precision("f32")
        base = ref_train.run_steps(loop.weights, names, batches, cfg)
        out = {}
        for label, mode, bs in (("control_tf32", "tf32", batches),
                                ("fault_half_batch", "f32", [half_batch(b) for b in batches])):
            ref.precision(mode)
            got = ref_train.run_steps(loop.weights, names, bs, cfg)
            prog = {"losses": got["loss_all"], "grad": got["grad"], "names": names,
                    "init": [loop.weights[n] for n in names], "after": got["params"]}
            out[label] = check.train_gaps(loop, prog, base)
        ref.precision("f32")
        return out
    if loop.kind == "eval":
        pool = loop.pool
        cat = lambda f: np.concatenate([f(b) for b in pool])  # noqa: E731
        args = (cat(lambda b: b["inp"]["feats"]), cat(lambda b: b["inp"]["voxel_idx"]),
                cat(lambda b: b["labels"]["obj_idx"]), device)
        gt = (cat(lambda b: b["labels"]["rot_gt"]), cat(lambda b: b["labels"]["trans_gt"]))
    else:
        loop.window(seconds)
        frames = loop.frames
        pick = check.serve_sample(frames, loop.seed, int(loop.cell.traffic["checked_frames"]))
        idx = np.concatenate([frames.rows[k] for k in pick])
        r = loop.rows
        args = (r["inp"]["feats"][idx], r["inp"]["voxel_idx"][idx],
                r["labels"]["obj_idx"][idx], device)
    # the control: the reference in TF32 in the program's place, scoring
    # its poses in TF32; the judge: the float32 reference
    ref.precision("tf32")
    ctl = check.reference_poses(loop.weights, cfg["model"], loop.bank, *args)
    if loop.kind == "eval":
        ctl["adds"] = check.reference_adds(loop.model_points, args[2], ctl["rot_pred"],
                                           ctl["trans_pred"], *gt, device)
    ref.precision("f32")
    base = check.reference_poses(loop.weights, cfg["model"], loop.bank, *args)
    if loop.kind == "eval":
        base["adds"] = check.reference_adds(loop.model_points, args[2], base["rot_pred"],
                                            base["trans_pred"], *gt, device)
    return {"control_tf32": check.pose_numbers(ctl, base)}


def main(argv=None) -> int:
    import torch

    from gpu_bench.harness import check
    from gpu_bench.harness.loops import make_loop
    from gpu_bench.harness.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        loop = make_loop(cell, seed, device)
        loop.setup()
        loop.window(args.seconds)
        numbers = check.compare(loop, loop.program_outputs(), device)
        print(json.dumps({"cell": cell.name, "reading": "program", "seed": seed, **numbers}),
              flush=True)
        del loop
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        loop = make_loop(cell, seed, device)
        loop.setup()
        for label, numbers in control_numbers(loop, device, args.seconds).items():
            print(json.dumps({"cell": cell.name, "reading": label, "seed": seed, **numbers}),
                  flush=True)
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
