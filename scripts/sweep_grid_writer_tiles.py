#!/usr/bin/env python3
"""Tile sizes of the two kernels that write a dense grid a tile per block,
K1 (voxelize) and K5 (the compaction's backward), on one GPU.

Usage, from the root of the repository:  python3 scripts/sweep_grid_writer_tiles.py

At the main path's shapes (configs/config_YCBV_bs32.yaml: batch 32, 1024
points, 64^3 grid; for K5 the four levels of one backbone branch, on K2's
outputs), for each tile size: holds the kernel bit-equal to its plain
version, and prints its device time (CUDA-graph replay, chip_smoke.graph_ms)
beside a torch.zeros of the same output bytes and the bound of the bytes
written. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32
VOX_TILES = (1024, 1536, 2048, 4096)
BWD_TILE_BYTES = (8192, 16384, 32768)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_grid_writer_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import PEAK_BYTES, check, graph_ms
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.ops import cuda_build, cuda_compact, cuda_voxelize

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    strict_f32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    cuda_build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    mcfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml")).model
    grid_shape = tuple(int(d) for d in mcfg.voxel_num_limit)
    ds = SyntheticPoseDataset(n_objects=16, n_points=int(mcfg.n_inp),
                              unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                              voxel_num_limit=grid_shape, seed=0)
    tb = batch_to_torch(make_batch([ds[i] for i in range(BATCH)]).to_dict(), dev)
    feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
    b, n, c = feats.shape
    g = grid_shape[0] * grid_shape[1] * grid_shape[2]

    # ---- K1 --------------------------------------------------------------
    want = {m: cuda_voxelize.voxelize_reference(feats, vidx, grid_shape, m) for m in (3, 4)}
    out_bytes = b * g * (c + 1) * 4
    zeros_ms = graph_ms(lambda: torch.zeros(b * g * (c + 1), device=dev))
    print(f"K1 [{b},{n},{c}] -> {grid_shape} on {card}: torch.zeros of its {out_bytes} "
          f"output bytes {zeros_ms:.4f} ms, bytes bound {out_bytes / PEAK_BYTES * 1e3:.4f} ms",
          flush=True)
    default = cuda_voxelize.TILE
    try:
        for tile in VOX_TILES:
            cuda_voxelize.TILE = tile
            for m in (3, 4):
                got = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, m)
                check(torch.equal(got[0], want[m][0]) and torch.equal(got[1], want[m][1]),
                      f"K1 tile {tile} mode {m}: not bit-equal to the plain version")
            t = graph_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4))
            print(f"K1 tile {tile} cells ({(g + tile - 1) // tile * b} blocks, "
                  f"{cuda_voxelize.list_smem_bytes(n, c)} B shared): bit-equal, device "
                  f"{t:.4f} ms", flush=True)
    finally:
        cuda_voxelize.TILE = default

    # ---- K5, on K2's outputs at the four levels of one branch ------------
    model = DCLNet.from_config(mcfg, seed=0)
    grid, count = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4)
    with torch.inference_mode():
        pyramid = model.backbone_inp(grid, (count > 0).to(torch.float32))
    pf = model.point_feats_inp
    gen = torch.Generator(device=dev).manual_seed(0)
    levels = []
    for level, (lf, lm) in enumerate(pyramid):
        lf, lm = lf.contiguous(), lm.contiguous()
        dims = tuple(lf.shape[1:4])
        cap = min(pf.capacities[level], dims[0] * dims[1] * dims[2])
        coords, _, vmask, _ = cuda_compact.dense_to_sparse_cuda(lf, lm, cap)
        dv = torch.randn((b, cap, lf.shape[-1]), device=dev, generator=gen)
        ref = cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask, dims)
        levels.append((dv, coords, vmask, dims, ref))
    grid_bytes = sum(r.numel() * 4 for *_, r in levels)
    zeros_ms = sum(graph_ms(lambda: torch.zeros(r.numel(), device=dev)) for *_, r in levels)
    print(f"K5 over the 4 levels on {card}: torch.zeros of the {grid_bytes} grid bytes "
          f"{zeros_ms:.4f} ms, bytes bound {grid_bytes / PEAK_BYTES * 1e3:.4f} ms", flush=True)
    default = cuda_compact.BWD_TILE_BYTES
    try:
        for tile_bytes in BWD_TILE_BYTES:
            cuda_compact.BWD_TILE_BYTES = tile_bytes
            per_level = []
            for level, (dv, coords, vmask, dims, ref) in enumerate(levels):
                got = cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, dims)
                check(torch.equal(got, ref),
                      f"K5 tile {tile_bytes} B level {level}: not bit-equal")
                per_level.append(graph_ms(
                    lambda: cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, dims)))
            print(f"K5 tile {tile_bytes} B: bit-equal, device {sum(per_level):.4f} ms "
                  f"(levels {', '.join(f'{t:.4f}' for t in per_level)})", flush=True)
    finally:
        cuda_compact.BWD_TILE_BYTES = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
