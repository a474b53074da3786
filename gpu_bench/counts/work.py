"""The work of the model on given inputs, counted from their shapes and
masks: the sparse FLOPs behind `mfu_pct`, and the bytes and operations of
each hand kernel launch behind `kernels_roofline_pct`.

FLOPs count what the sparse model computes, whatever runs it: each conv
layer 2 * C_in * C_out times its (active output site, active input
neighbour) pairs, which is what a sparse convolution (spconv) does for
these inputs, not the dense grid the program convolves; the heads' and the
fuse's matrix products from their shapes. No pooling or elementwise work
counts. The kernel bounds are a frozen copy of chip_smoke.py's per-kernel
byte and operation counts (K1, K2, K3 forward; K4, K5 backward).

Levels: the active sets of one branch, taken from the voxel indices as the
program's layers grow and pool them (regular convs dilate by 3^3,
submanifold convs keep the set, a 3^3 stride-2 pool keeps a cell where its
window holds one).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

DIMS = (7, 16, 32, 32, 64, 64, 128, 128, 256)
REGULAR = (0, 2, 4, 6)
POOL_AFTER = (1, 3, 5, 7)
POINT_FEATS = 480
DISENGAGE = ((256, 256), (256, 64), (256, 256), (256, 64))  # p1, m1, p2, m2


def input_mask(vidx: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """[B, D0, D1, D2] f32 occupancy of the points' voxels."""
    b, n, _ = vidx.shape
    d0, d1, d2 = (int(d) for d in grid)
    v = vidx.long()
    lin = (v[..., 0] * d1 + v[..., 1]) * d2 + v[..., 2]
    m = torch.zeros(b, d0 * d1 * d2, device=vidx.device)
    m.scatter_(1, lin, 1.0)
    return m.reshape(b, d0, d1, d2)


def _neighbours(m: torch.Tensor) -> torch.Tensor:
    """Active sites in each site's 3^3 neighbourhood (zero-padded)."""
    return F.avg_pool3d(F.pad(m[:, None], (1,) * 6), 3, 1, divisor_override=1)[:, 0]


def branch_counts(mask: torch.Tensor) -> Dict[str, object]:
    """One branch's per-sample counts from its input mask [B, D0, D1, D2]:
    conv FLOPs [B], and the pooled levels' occupancies (list of [B]) and
    shapes."""
    m = mask
    flops = torch.zeros(mask.shape[0], dtype=torch.float64, device=mask.device)
    occ, shapes = [], []
    for i in range(len(DIMS) - 1):
        out = F.max_pool3d(m[:, None], 3, 1, 1)[:, 0] if i in REGULAR else m
        pairs = (out * _neighbours(m)).sum((1, 2, 3)).double()
        flops += 2.0 * DIMS[i] * DIMS[i + 1] * pairs
        m = out
        if i in POOL_AFTER:
            m = (F.avg_pool3d(F.pad(m[:, None], (1,) * 6), 3, 2, divisor_override=1)[:, 0]
                 > 0).float()
            occ.append(m.sum((1, 2, 3)))
            shapes.append(tuple(m.shape[1:]))
    return {"conv_flops": flops, "occupancy": occ, "level_shapes": shapes}


def _mlp_flops(in_dim: int, dims: Sequence[int]) -> int:
    total = 0
    for d in dims:
        total += 2 * in_dim * d
        in_dim = d
    return total


def head_flops(n: int, m: int, template_heads: bool) -> float:
    """Matrix products of one row after the backbones: the disengage heads
    (the template's only when it is not cached), the two attentions and
    their gathers, the Xo / Yc, confidence and neck heads, the pose heads."""
    dis = sum(_mlp_flops(POINT_FEATS, d) for d in DISENGAGE)
    total = n * dis + (m * dis if template_heads else 0)
    total += 2 * n * m * (64 + 256 + 64) * 2            # attention, re-embed, m gather; both ways
    total += (n + m) * _mlp_flops(256, (256, 128, 3))    # regressor_Xo on n, regressor_Yc on m
    total += (n + m) * _mlp_flops(128, (128, 128, 1))    # confidence heads
    total += (n + m) * _mlp_flops(512, (512, 512, 1024))  # neck fusers
    total += _mlp_flops(1024, (512, 128, 9)) + _mlp_flops(1024, (512, 128, 3))
    return float(total)


def kernel_bytes_flops(b: int, n: int, c_in: int, grid: Sequence[int], counts: Dict,
                       capacities: Sequence[int], backward: bool) -> List[Dict[str, float]]:
    """Bytes and operations of one branch's hand-kernel launches for a batch
    of b rows (chip_smoke.py's counts): K1 on the input grid, K2 and K3 at
    each level, and with `backward` K4 and K5 at each level."""
    out = []
    g = int(grid[0]) * int(grid[1]) * int(grid[2])
    multi = counts["multi_voxels"]
    out.append({"kernel": "K1", "bytes": b * n * (c_in + 3) * 4 + b * g * (c_in + 1) * 4,
                "flops": b * n * (c_in + 1) + multi * c_in})
    for level, (occ, shape) in enumerate(zip(counts["occupancy"], counts["level_shapes"])):
        gl = shape[0] * shape[1] * shape[2]
        c = DIMS[2 * level + 2]
        cap = min(int(capacities[level]), gl)
        sel = float(torch.clamp(occ, max=cap).sum())
        out.append({"kernel": "K2", "bytes": b * gl * 4 + sel * c * 4 + b * cap * (c + 4) * 4 + b * 4,
                    "flops": 0.0})
        out.append({"kernel": "K3",
                    "bytes": (b * n * 3 + sel * (3 + 1 + c) + b + b * n * c + 2 * b * 3 * n) * 4,
                    "flops": 8 * n * sel + 5 * b * n * c})
        if backward:
            out.append({"kernel": "K4", "bytes": (b * n * c + 2 * b * 3 * n + b * cap * c) * 4,
                        "flops": 6 * b * n * c})
            out.append({"kernel": "K5", "bytes": (sel * c + b * cap * 4 + b * gl * c) * 4,
                        "flops": 0.0})
    return out


def multi_voxels(vidx: torch.Tensor, grid: Sequence[int]) -> float:
    """Voxels that hold more than one point (K1's divides)."""
    b, n, _ = vidx.shape
    d0, d1, d2 = (int(d) for d in grid)
    v = vidx.long()
    lin = (v[..., 0] * d1 + v[..., 1]) * d2 + v[..., 2]
    cnt = torch.zeros(b, d0 * d1 * d2, device=vidx.device)
    cnt.scatter_add_(1, lin, torch.ones_like(lin, dtype=torch.float32))
    return float((cnt > 1).sum())


def batch_work(batch: Dict, model_cfg: Dict, branches: Sequence[str], train: bool
               ) -> Dict[str, float]:
    """The work of one forward (and, with `train`, backward) of the model on
    a batch dict of tensors: FLOPs (the backward counted as twice the
    forward) and the summed bound seconds of the hand kernels' launches.
    `branches` are the branches the
    timed path encodes per row ("inp", and "tmp" where the template is not
    cached)."""
    from gpu_bench.counts.peaks import bound

    grid = tuple(int(d) for d in model_cfg["voxel_num_limit"])
    flops, kbound = 0.0, 0.0
    n = batch["inp"]["feats"].shape[1]
    m = batch["tmp"]["feats"].shape[1]
    b = batch["inp"]["feats"].shape[0]
    for side in branches:
        vidx = batch[side]["voxel_idx"]
        counts = branch_counts(input_mask(vidx, grid))
        counts["multi_voxels"] = multi_voxels(vidx, grid)
        flops += float(counts["conv_flops"].sum())
        for k in kernel_bytes_flops(b, vidx.shape[1], batch[side]["feats"].shape[2], grid,
                                    counts, model_cfg["capacities"], train):
            kbound += bound(k["bytes"], k["flops"])[0]
    flops += b * head_flops(n, m, template_heads="tmp" in branches)
    if train:
        flops *= 3.0
    return {"flops": flops, "kernel_bound_s": kbound}
