#!/usr/bin/env python3
"""Where the time of the PyTorch port's stage-1 training step goes, on one GPU.

Usage, from the root of the repository:  python3 scripts/profile_torch_train.py

Runs the training path of chip_smoke.py (the full-width DCLNet of
configs/config_YCBV_bs32.yaml with seeded random weights, that config's
optimizer and schedule, batches of 32 from the synthetic dataset) and prints:
 1. the device time of one train step by stage, from CUDA events that the
    step records as it queues each stage (make_train_step's on_stage hook):
    forward, loss, backward, optimizer (flat gradient, AutoClip, Adam,
    update, non-finite select);
 2. from torch.profiler around one forward and, separately, one backward:
    device time by kernel group in each;
 3. from torch.profiler over Solver.train_epoch: the device busy and idle
    share of the window and the top kernels by device time.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32
WARMUP = 2
STAGE_STEPS = 5
EPOCH_STEPS = 4
GROUPS = (  # kernel-name substrings -> group, first match wins
    ("K1 voxelize", ("voxelize_tiles",)),
    ("K5 compact bwd", ("compact_occupied_bwd",)),  # before K2's prefix
    ("K4/K7 inverse index", ("build_csr",)),
    ("K7 fused bwd", ("compact_interp_grid_bwd",)),
    ("K4 interp bwd", ("interp_rows_bwd",)),
    ("K2 compact", ("compact_occupied",)),
    ("K3 interp", ("interp_three_nn",)),
    ("conv3d wgrad", ("wgrad",)),
    ("conv3d dgrad", ("dgrad",)),
    ("conv3d (cuDNN)", ("fprop", "conv", "cudnn", "winograd", "implicit")),
    ("pooling", ("pool",)),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("svd/linalg", ("svd", "gesvd", "batched", "lu_", "getrf", "syevj", "gesvdj")),
    ("sort/gather/scatter", ("sort", "gather", "index", "scatter", "radix")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "fill", "cat")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def kernel_summary(prof):
    """(kernels, busy us, window us) of a profile."""
    import torch

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return kernels, 0.0, 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    host = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
    window = (max(max(e.time_range.end for e in host), spans[-1][1])
              - min(min(e.time_range.start for e in host), spans[0][0]))
    return kernels, busy, window


def print_groups(title: str, kernels) -> None:
    by_group = {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + d
    total = sum(by_group.values())
    print(f"{title}: {total / 1e3:.3f} ms of kernel time")
    for g, d in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:22s} {d / 1e3:9.3f} ms  {100 * d / total:5.1f} %")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.train.solver import Solver, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    strict_f32()
    dev = torch.device("cuda")

    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml"))
    cfg = cfg.merge({"per_write": 1, "per_save": 0})
    mcfg = cfg.model
    n_steps = WARMUP + STAGE_STEPS + 2 + EPOCH_STEPS
    ds = SyntheticPoseDataset(n_objects=16, n_points=int(mcfg.n_inp),
                              unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                              voxel_num_limit=tuple(int(d) for d in mcfg.voxel_num_limit),
                              length=BATCH * n_steps, seed=0)
    loader = BatchLoader(ds, batch_size=BATCH, num_workers=8, seed=1)
    host_batches = list(loader)
    batches = [batch_to_torch(b, dev) for b in host_batches[:WARMUP + STAGE_STEPS + 2]]
    model = DCLNet.from_config(mcfg, seed=0)
    solver = Solver(model, dcl_losses, cfg, loader)
    solver.initialize()

    # ---- 1. per-stage device time of one step, CUDA events --------------------
    marks = []

    def mark(stage):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((stage, event))

    timed_step = make_train_step(model, solver.opt, dcl_losses, on_stage=mark)
    for b in batches[:WARMUP]:
        solver.train_step(solver.state, b)
    torch.cuda.synchronize()
    stages = ("forward", "loss", "backward", "optimizer")
    runs = {s: [] for s in stages}
    for b in batches[WARMUP:WARMUP + STAGE_STEPS]:
        marks.clear()
        mark("start")
        timed_step(solver.state, b)
        torch.cuda.synchronize()
        for (_, e0), (stage, e1) in zip(marks[:-1], marks[1:]):
            runs[stage].append(e0.elapsed_time(e1))
    total = sum(statistics.median(v) for v in runs.values())
    print(f"per-stage device time of one train step of batch {BATCH} "
          f"(median of {STAGE_STEPS}, CUDA events):")
    for s in stages:
        m = statistics.median(runs[s])
        print(f"  {s:12s} {m:9.3f} ms  {100 * m / total:5.1f} %")
    print(f"  {'total':12s} {total:9.3f} ms")

    # ---- 2. kernel groups of one forward and of one backward -------------------
    params = [p for p in model.parameters() if p.requires_grad]
    b = batches[WARMUP + STAGE_STEPS]
    model.train()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_f:
        losses = dcl_losses(model(b), b)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_b:
        torch.autograd.grad(losses["loss_all"], params)
        torch.cuda.synchronize()
    fk, _, _ = kernel_summary(prof_f)
    bk, _, _ = kernel_summary(prof_b)
    if not fk or not bk:
        print("profiler recorded no device kernels: groups not measured")
        return 1
    print_groups("forward + loss, device time by kernel group", fk)
    print_groups("backward, device time by kernel group", bk)

    # ---- 3. Solver.train_epoch under the profiler: idle share -----------------
    loader.skip_next = WARMUP + STAGE_STEPS + 2
    solver.epoch = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        avg = solver.train_epoch()
        torch.cuda.synchronize()
    kernels, busy, window = kernel_summary(prof)
    print(f"train_epoch over {EPOCH_STEPS} steps under the profiler: device busy "
          f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, idle share "
          f"{100 * (1 - busy / window):.1f} %; mean T_step {avg['T_step']:.4f} s "
          f"T_data {avg['T_data']:.4f} s")
    print_groups("train_epoch, device time by kernel group", kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    print("top kernels by device time:")
    for name, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {d / 1e3:9.3f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
