#!/usr/bin/env python3
"""Tile sizes of the 3-NN interpolation's two backward kernels, K4 (into the
compacted rows) and K7 (onto the grid), on one GPU.

Usage, from the root of the repository:  python3 scripts/sweep_interp_bwd_tiles.py

At the main path's shapes (configs/config_YCBV_bs32.yaml: batch 32, 1024
points, 64^3 grid; the four levels of one backbone branch, on K2's, K3's
and K6's outputs), first holds both kernels and their inverse index
bit-equal to the plain versions run on CPU copies, and from launch to
launch, on the main-path inputs and on chip_smoke's adversarial set, and
prints the inverse index's device time alone and how many contributions
the slots take; then prints K4's device time per level (CUDA-graph replay,
chip_smoke.graph_ms) and K7's for each of its tile sizes
(cuda_compact.BWD_TILE_BYTES, which K7 shares with K5, and
cuda_fused.BWD_MIN_BLOCKS). Needs a CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32
TILE_BYTES = (4096, 16384)
MIN_BLOCKS = (1024, 2048, 4096, 8192)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_interp_bwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (adversarial_bwd_inputs, bit_equal_on_cpu, check_inverse_index,
                            graph_ms)
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.ops import (cuda_build, cuda_compact, cuda_fused, cuda_interp,
                                       cuda_voxelize)
    from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers

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
    points = feats[..., 4:7].contiguous()
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
        coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(lf, lm, cap)
        centers = voxel_centers(coords, pf.unit, pf.scale_list[level], pf.offset)
        _, w, idx = cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask)
        _, w6, idx6 = cuda_fused.compact_interpolate_cuda(points, coords, vfeats, vmask, occ,
                                                          *pf.center_affine[level])
        g = torch.randn((BATCH, points.shape[1], lf.shape[-1]), device=dev, generator=gen)
        k4 = (g, w, idx, cap)
        k7 = (g, w6, idx6, coords, vmask, dims)
        for name, kernel, plain, args in (
                ("K4", cuda_interp.nn_interpolate_bwd_cuda,
                 cuda_interp.nn_interpolate_bwd_reference, k4),
                ("K7", cuda_fused.compact_interpolate_bwd_cuda,
                 cuda_fused.compact_interpolate_bwd_reference, k7)):
            ga, ia = adversarial_bwd_inputs(g, args[2], vmask, seed=level)
            for gi, ii, what in ((g, args[2], ""), (ga, ia, ", adversarial")):
                check_inverse_index(ii, cap, f"{name} level {level}{what}")
                bit_equal_on_cpu(kernel, plain, (gi, args[1], ii, *args[3:]),
                                 f"{name} level {level}{what}")
        levels.append((k4, k7))
        rows = torch.diff(cuda_interp.inverse_index_reference(idx6.cpu(), cap)[0], dim=1)
        print(f"level {level} {dims} C {lf.shape[-1]} cap {cap}: K4, K7 and the inverse "
              f"index bit-equal to the plain versions on the CPU and launch to launch, "
              f"on the main-path and the adversarial inputs; index device "
              f"{graph_ms(lambda: cuda_interp.inverse_index_cuda(idx, cap)):.4f} ms; "
              f"contributions per slot (K6's idx): max {int(rows.max())}, mean over "
              f"slots that take any {float(rows[rows > 0].float().mean()):.1f}", flush=True)

    t4 = [graph_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(*k4)) for k4, _ in levels]
    print(f"K4 on {card}: device {sum(t4):.4f} ms ({', '.join(f'{t:.4f}' for t in t4)})",
          flush=True)
    defaults = cuda_compact.BWD_TILE_BYTES, cuda_fused.BWD_MIN_BLOCKS
    try:
        for tile_bytes in TILE_BYTES:
            for min_blocks in MIN_BLOCKS:
                cuda_compact.BWD_TILE_BYTES, cuda_fused.BWD_MIN_BLOCKS = tile_bytes, min_blocks
                t7 = [graph_ms(lambda: cuda_fused.compact_interpolate_bwd_cuda(*k7))
                      for _, k7 in levels]
                print(f"K7 tile {tile_bytes} B, at least {min_blocks} blocks on {card}: "
                      f"device {sum(t7):.4f} ms ({', '.join(f'{t:.4f}' for t in t7)})",
                      flush=True)
    finally:
        cuda_compact.BWD_TILE_BYTES, cuda_fused.BWD_MIN_BLOCKS = defaults
    return 0


if __name__ == "__main__":
    sys.exit(main())
