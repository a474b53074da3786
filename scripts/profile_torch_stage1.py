#!/usr/bin/env python3
"""Where the time of the PyTorch port's stage-1 eval goes, on one GPU.

Usage, from the root of the repository:
    python3 scripts/profile_torch_stage1.py [--dtype float32|bfloat16]

Runs the main path of chip_smoke.py (the full-width DCLNet of
configs/config_YCBV_bs32.yaml with seeded random weights, the synthetic
16-class template bank, batches of 32), in the compute type --dtype
(model.compute_dtype; default float32), and prints:
 1. a per-stage breakdown of one batch with CUDA events: voxelize (K1),
    backbone (8 convs + 4 pools), point features (4 x K2 + K3), disengage
    heads, fusion, ADD-S (`stage_breakdown`, which chip_smoke.py also
    calls);
 2. from torch.profiler over a whole Evaluator.evaluate: device time by
    kernel group, the device busy and idle share of the window, and the
    top kernels by device time.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32
N_BATCHES = 4
STAGES = ("voxelize K1", "backbone", "point feats K2+K3", "disengage heads",
          "template gather + fuse", "ADD-S")
GROUPS = (  # kernel-name substrings -> group, first match wins
    ("K1 voxelize", ("voxelize_tiles",)),
    ("K2 compact", ("compact_count", "compact_write")),
    ("K3 interp", ("three_nn_rows",)),
    ("conv3d (cuDNN)", ("fprop", "conv", "cudnn", "winograd")),
    ("pooling", ("pool",)),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("svd/linalg", ("svd", "gesvd", "batched", "lu_", "getrf", "syevj", "gesvdj")),
    ("sort/gather", ("sort", "gather", "index", "scatter", "radix")),
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


def stage_breakdown(model, ev, tb, reps: int = 10) -> dict:
    """Median device ms of each of STAGES for one batch tb (on the card) of
    the stage-1 eval path of `model` with Evaluator ev's template cache,
    from CUDA events around each stage, over `reps` runs."""
    import torch

    from dcl_net_tpu_torch.eval.metrics import add_s_batch
    from dcl_net_tpu_torch.ops.cuda_voxelize import voxelize_cuda

    cls = tb["labels"]["obj_idx"].long()
    runs = {s: [] for s in STAGES}
    with torch.inference_mode():
        for _ in range(reps):
            ev_marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
            ev_marks[0].record()
            feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
            grid, count = voxelize_cuda(feats, vidx, model.grid_shape, model.voxelization_mode,
                                        out_dtype=model.dtype)
            mask = (count > 0).to(feats.dtype)
            ev_marks[1].record()
            pyramid = model.backbone_inp(grid, mask)
            ev_marks[2].record()
            points = feats[..., 4:7].contiguous()
            f, overflow = model.point_feats_inp(points, pyramid)
            ev_marks[3].record()
            obs = model._heads("Xc", points, f, overflow)
            ev_marks[4].record()
            tmp = {k: v[cls] for k, v in ev._tmp_cache.items()}
            out = model.fuse(obs, tmp)
            ev_marks[5].record()
            add_s_batch(ev.model_points[cls], out["rot_pred"].float(),
                        out["trans_pred"].float(), tb["labels"]["rot_gt"],
                        tb["labels"]["trans_gt"])
            ev_marks[6].record()
            torch.cuda.synchronize()
            for i, s in enumerate(STAGES):
                runs[s].append(ev_marks[i].elapsed_time(ev_marks[i + 1]))
    return {s: statistics.median(v) for s, v in runs.items()}


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the model's compute type (model.compute_dtype)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_stage1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.models.dcl_net import COMPUTE_DTYPES, DCLNet

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"{card}; compute dtype {args.dtype}", flush=True)
    strict_f32()

    mcfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml")).model
    grid_shape = tuple(int(d) for d in mcfg.voxel_num_limit)
    ds = SyntheticPoseDataset(n_objects=16, n_points=int(mcfg.n_inp),
                              unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                              voxel_num_limit=grid_shape, seed=0)
    batches = [make_batch([ds[BATCH * j + i] for i in range(BATCH)]).to_dict()
               for j in range(N_BATCHES)]
    model_points = np.stack([ds.model_points(c, 1024) for c in range(16)])
    model = DCLNet.from_config(mcfg, seed=0, dtype=COMPUTE_DTYPES[args.dtype])
    ev = Evaluator(model, model_points, template_bank=ds.template_bank())
    ev.evaluate(batches[:1])  # warm-up: cuDNN algorithm choice, allocator

    # ---- 1. per-stage breakdown of one batch, CUDA events ----------------
    stages = stage_breakdown(model, ev, batch_to_torch(batches[0], torch.device("cuda")))
    total = sum(stages.values())
    print(f"per-stage device time of one batch of {BATCH} (median of 10, CUDA events):")
    for s, m in stages.items():
        print(f"  {s:24s} {m:9.3f} ms  {100 * m / total:5.1f} %")
    print(f"  {'total':24s} {total:9.3f} ms")

    # ---- 2. torch.profiler over Evaluator.evaluate ------------------------------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.evaluate(batches)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profiler recorded no device kernels: device time by group not measured")
        return 1
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
    by_group, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    ktotal = sum(by_group.values())
    print(f"evaluate over {N_BATCHES} batches under the profiler: device busy "
          f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, idle share "
          f"{100 * (1 - busy / window):.1f} %")
    print("device time by kernel group:")
    for g, d in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:20s} {d / 1e3:9.3f} ms  {100 * d / ktotal:5.1f} %")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    print("top kernels by device time:")
    for name, d in top[:12]:
        print(f"  {d / 1e3:9.3f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
