#!/usr/bin/env python3
"""Host time a call of the compaction K2 and the 3-NN interpolation K3 wrappers
on one GPU, at the main path's shapes.

Usage, from the root of a checkout:  python3 scripts/host_overhead_interp_compact.py

The script measures the package of the checkout it sits in, so a copy of it
placed in another checkout measures that one. For each of the four levels
of one backbone branch (configs/config_YCBV_bs32.yaml: batch 32, 1024
points; grids 32^3 .. 4^3, C 32 .. 256, capacities 2048 .. 64; about 2 % of
cells occupied) it puts the card to sleep for longer than the calls take
(torch.cuda._sleep), then times CALLS wrapper calls on the host clock, so
that every launch only queues: the time is the wrapper's own host work
(checks, allocations, launches), with no wait on the device. It prints the
median of REPEATS such loops per level and their mean over the levels, in
us a call. K3 is called with n_valid (K2's occupancy) where the wrapper
takes it, as the main path calls it. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import inspect
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32
N_POINTS = 1024
LEVELS = ((32, 32, 2048), (16, 64, 1024), (8, 128, 512), (4, 256, 64))  # (edge, C, cap)
CALLS = 200
REPEATS = 7
SLEEP_CYCLES = 400_000_000  # about 0.2 s on an H100: longer than CALLS calls take


def host_us(fn) -> float:
    import torch

    times = []
    for _ in range(REPEATS):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        times.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("host_overhead_interp_compact: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.ops import cuda_build, cuda_compact, cuda_interp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    strict_f32()
    cuda_build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    takes_n_valid = "n_valid" in inspect.signature(cuda_interp.nn_interpolate_cuda).parameters
    points = torch.rand((BATCH, N_POINTS, 3), device=dev, generator=gen)
    k2, k3 = [], []
    for edge, c, cap in LEVELS:
        feats = torch.randn((BATCH, edge, edge, edge, c), device=dev, generator=gen)
        mask = (torch.rand((BATCH, edge, edge, edge), device=dev, generator=gen)
                < 0.02).to(torch.float32)
        coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(feats, mask, cap)
        centers = coords.to(torch.float32) / edge
        extra = (occ,) if takes_n_valid else ()
        k2.append(host_us(lambda: cuda_compact.dense_to_sparse_cuda(feats, mask, cap)))
        k3.append(host_us(lambda: cuda_interp.nn_interpolate_cuda(
            points, centers, vfeats, vmask, *extra)))
    for name, t in (("K2 dense_to_sparse_cuda", k2), ("K3 nn_interpolate_cuda", k3)):
        print(f"{name} host time a call on {card} ({ROOT.name}): mean "
              f"{statistics.mean(t):.1f} us over the 4 levels "
              f"({', '.join(f'{x:.1f}' for x in t)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
