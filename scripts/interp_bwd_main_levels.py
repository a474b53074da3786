#!/usr/bin/env python3
"""K4 and K7 over the four levels of the main path, on one GPU: bit-equality
with their plain versions on CPU copies, then device time.

Usage, from the root of a checkout (or of another tree of the repository,
such as an unpacked parent commit, to compare two versions in one call):
    python3 scripts/interp_bwd_main_levels.py [label] [--wide]

Inputs are drawn from a seed: batch 32, 1024 points, the four levels of one
branch (32^3 cap 2048 C 32, 16^3 cap 1024 C 64, 8^3 cap 512 C 128, 4^3 cap
64 C 256) with the mean occupancies of the main path (490, 248, 148, 62,
PERF.md section 4) in K2's layout, and indices drawn uniformly over the
occupied slots. Each kernel, f32 and bf16 cotangent, is held bit-equal to
its plain version on CPU copies, then timed on the device alone (a CUDA
graph of 10 calls replayed 10 times, the median of 3 such runs); the line
printed sums the four levels. --wide also checks both kernels bit-equal at
[2, 8192, 512] with one slot taking every contribution of a sample (the
chunked inverse index and two channel slices). Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
BATCH, N_POINTS = 32, 1024
LEVELS = ((32, 2048, 32, 490), (16, 1024, 64, 248), (8, 512, 128, 148), (4, 64, 256, 62))


def graph_ms(fn, calls: int = 10, reps: int = 10, rounds: int = 3) -> float:
    """Device ms of fn() from CUDA-graph replays (chip_smoke.py's graph_ms)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / (calls * reps))
    return statistics.median(times)


def k2_layout(gen, b: int, cap: int, d: int, occ: int, dev):
    """coords [b, cap, 3] and vmask [b, cap]: occ slots of rising linear
    index, zeros past them."""
    import torch

    coords = torch.zeros((b, cap, 3), dtype=torch.int32)
    vmask = torch.zeros((b, cap))
    for i in range(b):
        lin = torch.sort(torch.randperm(d ** 3, generator=gen)[:occ]).values
        coords[i, :occ] = torch.stack([lin // (d * d), (lin // d) % d, lin % d], -1).int()
        vmask[i, :occ] = 1.0
    return coords.to(dev), vmask.to(dev)


def check_both(g, w, idx, coords, vmask, grid, what: str) -> None:
    """K4 and K7 on the card bit-equal to their plain versions on CPU copies."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_fused, cuda_interp

    cap = coords.shape[1]
    cpu = [t.cpu() for t in (g, w, idx, coords, vmask)]
    if not torch.equal(cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap).cpu(),
                       cuda_interp.nn_interpolate_bwd_reference(*cpu[:3], cap)):
        raise SystemExit(f"K4 differs from its plain version at {what}")
    if not torch.equal(cuda_fused.compact_interpolate_bwd_cuda(g, w, idx, coords, vmask,
                                                               grid).cpu(),
                       cuda_fused.compact_interpolate_bwd_reference(*cpu, grid)):
        raise SystemExit(f"K7 differs from its plain version at {what}")


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    wide = "--wide" in args
    label = next((a for a in args if not a.startswith("--")), str(ROOT))
    if not torch.cuda.is_available():
        print("interp_bwd_main_levels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch.ops import cuda_build, cuda_fused, cuda_interp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cuda_build.library()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    total = {}
    for d, cap, c, occ in LEVELS:
        coords, vmask = k2_layout(gen, BATCH, cap, d, occ, dev)
        idx = torch.randint(0, occ, (BATCH, 3, N_POINTS), generator=gen,
                            dtype=torch.int32).to(dev)
        w = torch.rand((BATCH, 3, N_POINTS), generator=gen).to(dev)
        g32 = torch.randn((BATCH, N_POINTS, c), generator=gen).to(dev)
        for name, g in (("f32", g32), ("bf16", g32.to(torch.bfloat16))):
            check_both(g, w, idx, coords, vmask, (d,) * 3, f"level {d}^3 {name}")
            total[f"K4 {name}"] = total.get(f"K4 {name}", 0.0) + graph_ms(
                lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap))
            total[f"K7 {name}"] = total.get(f"K7 {name}", 0.0) + graph_ms(
                lambda: cuda_fused.compact_interpolate_bwd_cuda(g, w, idx, coords, vmask,
                                                                (d,) * 3))
    print(f"{label}: device ms over the 4 levels, each bit-equal to its plain version: "
          + ", ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)
    if wide:
        b, n, c, cap, d = 2, 8192, 512, 1024, 16
        coords, vmask = k2_layout(gen, b, cap, d, 900, dev)
        idx = torch.randint(0, 900, (b, 3, n), generator=gen, dtype=torch.int32)
        idx[0] = 0  # one slot takes every contribution of sample 0
        idx = idx.to(dev)
        w = torch.rand((b, 3, n), generator=gen).to(dev)
        g32 = torch.randn((b, n, c), generator=gen).to(dev)
        for g in (g32, g32.to(torch.bfloat16)):
            check_both(g, w, idx, coords, vmask, (d,) * 3, f"[{b}, {n}, {c}] {g.dtype}")
        print(f"{label}: K4 and K7 at [{b}, {n}, {c}], f32 and bf16, bit-equal to their "
              f"plain versions", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
