#!/usr/bin/env python3
"""Block shapes of the main path's 3-NN interpolation K3, of the fused
compaction -> interpolation K6 that runs K3's kernel, and tile sizes of the
compaction K2, on one GPU.

Usage, from the root of the repository:  python3 scripts/sweep_interp_compact.py

At the main path's shapes (configs/config_YCBV_bs32.yaml: batch 32, 1024
points, 64^3 grid; the four levels of one backbone branch), for each of
K2's tile sizes (cuda_compact.TILE_CELLS) it first holds K2 bit-equal to its
plain version, with K5's precondition on its output, also with a capacity
below the occupancy and with an empty sample; and for each of K3's block
shapes (cuda_interp.SCAN_LANES lanes a query, cuda_interp.QUERIES queries a
block) it holds K3 with and without n_valid torch.equal to each other, idx
equal to the plain version's and out, w within chip_smoke.INTERP_ATOL, on
the main-path inputs and chip_smoke's adversarial set, and K6 (the same
block shape) torch.equal to K3 with n_valid on the main-path levels and
on chip_smoke's adversarial set in coords form. Then it prints each
variant's device time per level (CUDA-graph replay, chip_smoke.graph_ms),
K3 with n_valid (the main path's call) and without, and K6. Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 32


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_interp_compact: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (INTERP_ATOL, check, check_fused_adversarial,
                            check_interp_adversarial, check_slot_prefix, graph_ms, max_err)
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
    levels = []
    for level, (lf, lm) in enumerate(pyramid):
        lf, lm = lf.contiguous(), lm.contiguous()
        dims = tuple(lf.shape[1:4])
        cap = min(pf.capacities[level], dims[0] * dims[1] * dims[2])
        ref = cuda_compact.dense_to_sparse_reference(lf, lm, cap)
        occ = ref[3]
        centers = voxel_centers(ref[0], pf.unit, pf.scale_list[level], pf.offset)
        levels.append((lf, lm, cap, dims, ref, centers, pf.center_affine[level]))
        print(f"level {level} {dims} C {lf.shape[-1]} cap {cap}: occupancy min "
              f"{int(occ.min())} mean {float(occ.float().mean()):.1f} max {int(occ.max())}",
              flush=True)

    k2_default = cuda_compact.TILE_CELLS
    k3_default = cuda_interp.SCAN_LANES, cuda_interp.QUERIES
    try:
        for tile in cuda_compact.TILE_CHOICES:
            cuda_compact.TILE_CELLS = tile
            for level, (lf, lm, cap, dims, ref, _, _) in enumerate(levels):
                lm_e = lm.clone()
                lm_e[0] = 0.0  # an empty sample
                for cp, m in ((cap, lm), (max(1, int(ref[3].min()) // 2), lm), (cap, lm_e)):
                    got = cuda_compact.dense_to_sparse_cuda(lf, m, cp)
                    want = (ref if m is lm and cp == cap
                            else cuda_compact.dense_to_sparse_reference(lf, m, cp))
                    for a, r, name in zip(got, want, ("coords", "vfeats", "vmask", "occupancy")):
                        check(torch.equal(a, r), f"K2 tile {tile} level {level} cap {cp}: "
                              f"{name} not bit-equal to the plain version")
                    check_slot_prefix(got[0], got[2], got[3], cp, dims,
                                      f"K2 tile {tile} level {level} cap {cp}")
            t2 = [graph_ms(lambda: cuda_compact.dense_to_sparse_cuda(lf, lm, cap))
                  for lf, lm, cap, *_ in levels]
            print(f"K2 tile {tile} cells on {card}: bit-equal at every level, with overflow "
                  f"and an empty sample; device {sum(t2):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in t2)})", flush=True)
        for lanes in cuda_interp.LANE_CHOICES:
            for queries in cuda_interp.QUERY_CHOICES:
                cuda_interp.SCAN_LANES, cuda_interp.QUERIES = lanes, queries
                args = []
                for level, (lf, lm, cap, dims, ref, centers, affine) in enumerate(levels):
                    coords, vfeats, vmask, occ = ref
                    a = (points, centers, vfeats, vmask)
                    got = cuda_interp.nn_interpolate_cuda(*a, occ)
                    plain = cuda_interp.nn_interpolate_cuda(*a)
                    for x, y, name in zip(got, plain, ("out", "w", "idx")):
                        check(torch.equal(x, y), f"K3 S {lanes} Q {queries} level {level}: "
                              f"{name} with n_valid differs from without")
                    want = cuda_interp.nn_interpolate_reference(*a)
                    check(torch.equal(got[2], want[2]),
                          f"K3 S {lanes} Q {queries} level {level}: idx differ")
                    for x, y, name in zip(got[:2], want[:2], ("out", "w")):
                        e = max_err(x, y)
                        check(e <= INTERP_ATOL,
                              f"K3 S {lanes} Q {queries} level {level}: {name} differs by {e}")
                    a6 = (points, coords, vfeats, vmask, occ, *affine)
                    for x, y, name in zip(cuda_fused.compact_interpolate_cuda(*a6), got,
                                          ("out", "w", "idx")):
                        check(torch.equal(x, y), f"K6 S {lanes} Q {queries} level {level}: "
                              f"{name} differs from K3 with n_valid")
                    args.append((a, occ, a6))
                check_interp_adversarial(dev)
                check_fused_adversarial(dev)
                t3 = [graph_ms(lambda: cuda_interp.nn_interpolate_cuda(*a, occ))
                      for a, occ, _ in args]
                t3_all = [graph_ms(lambda: cuda_interp.nn_interpolate_cuda(*a))
                          for a, _, _ in args]
                t6 = [graph_ms(lambda: cuda_fused.compact_interpolate_cuda(*a6))
                      for _, _, a6 in args]
                print(f"K3 S {lanes} Q {queries} on {card}: checks passed; device with "
                      f"n_valid {sum(t3):.4f} ms ({', '.join(f'{t:.4f}' for t in t3)}), all "
                      f"rows {sum(t3_all):.4f} ms ({', '.join(f'{t:.4f}' for t in t3_all)}); "
                      f"K6 {sum(t6):.4f} ms ({', '.join(f'{t:.4f}' for t in t6)})",
                      flush=True)
    finally:
        cuda_compact.TILE_CELLS = k2_default
        cuda_interp.SCAN_LANES, cuda_interp.QUERIES = k3_default
    return 0


if __name__ == "__main__":
    sys.exit(main())
