"""Point-cloud voxelization on dense grids (plain PyTorch).

Counterpart of dcl_net_tpu/ops/voxelize.py for the two modes DCL-Net runs:
3 = sum and 4 = mean (cfg.voxelization_mode = 4). The hand-written kernel
that the main path uses on the card is ops/cuda_voxelize.py; the function
here is its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MODE_SUM = 3
MODE_MEAN = 4


def point_to_voxel_index(points: torch.Tensor, unit_voxel_extent,
                         voxel_num_limit) -> torch.Tensor:
    """Quantize metric points (centered on the volume) to int32 voxel indices
    ``floor((p + total / 2) / unit)``, clipped to [0, D - 1]."""
    unit = torch.as_tensor(unit_voxel_extent, dtype=points.dtype,
                           device=points.device)
    limit = torch.as_tensor(voxel_num_limit, dtype=points.dtype,
                            device=points.device)
    idx = torch.floor((points + 0.5 * (unit * limit)) / unit).to(torch.int32)
    hi = torch.as_tensor(voxel_num_limit, dtype=torch.int32,
                         device=points.device) - 1
    return torch.minimum(torch.clamp(idx, min=0), hi)


def voxelize_dense(
    feats: torch.Tensor,
    voxel_idx: torch.Tensor,
    grid_size: Tuple[int, int, int],
    mode: int = MODE_MEAN,
    point_mask: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter per-point features into a dense grid as a sum or a mean.

    Args:
      feats: [B, N, C] f32; voxel_idx: [B, N, 3] int; grid_size: (D0, D1, D2).
      point_mask: optional [B, N]; points with mask <= 0 add nothing.
      out_dtype: the grid's type (default feats.dtype). bfloat16 follows the
        JAX package's pallas_voxelize(out_dtype=bfloat16): the features are
        rounded to bf16, each voxel's sum of them is taken in f32 and
        stored as bf16, and mode 4 divides that bf16 sum (in f32) by the
        count and rounds to bf16 again.
    Points whose index lies outside the grid on any axis are dropped.

    Returns grid [B, D0, D1, D2, C] and exact counts [B, D0, D1, D2] (f32
    under bfloat16).

    Each voxel's sum is taken over its points in point order, as a serial
    scatter would: the points are sorted (stably) by voxel and added one
    rank at a time, so every step writes distinct voxels.
    """
    if mode not in (MODE_SUM, MODE_MEAN):
        raise NotImplementedError(f"voxelization mode {mode}")
    b, n, c = feats.shape
    d0, d1, d2 = (int(d) for d in grid_size)
    g = d0 * d1 * d2
    idx = voxel_idx.long()
    limit = torch.tensor([d0, d1, d2], device=idx.device)
    alive = ((idx >= 0) & (idx < limit)).all(-1)
    if point_mask is not None:
        alive = alive & (point_mask > 0)
    lin = (idx[..., 0] * d1 + idx[..., 1]) * d2 + idx[..., 2]
    lin = lin + torch.arange(b, device=idx.device)[:, None] * g
    bf16 = out_dtype == torch.bfloat16
    if bf16:  # bf16 payloads, summed in f32
        feats = feats.to(torch.bfloat16).to(torch.float32)
    lin, vals = lin[alive], feats[alive]  # row-major: (b, n) ascending
    vals = torch.cat([vals, torch.ones_like(vals[:, :1])], dim=1)
    order = torch.argsort(lin, stable=True)
    lin, vals = lin[order], vals[order]
    pos = torch.arange(lin.numel(), device=lin.device)
    starts = torch.ones_like(lin, dtype=torch.bool)
    starts[1:] = lin[1:] != lin[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, 0), dim=0).values
    flat = torch.zeros(b * g, c + 1, dtype=feats.dtype, device=feats.device)
    n_ranks = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(n_ranks):
        sel = rank == r
        rows = lin[sel]
        flat[rows] = flat[rows] + vals[sel]
    grid, count = flat[:, :c], flat[:, c]
    if bf16:
        grid = grid.to(torch.bfloat16)
    if mode == MODE_MEAN:
        grid = grid / torch.clamp(count, min=1.0)[:, None]
        if bf16:  # the bf16 sum over the f32 count, rounded once
            grid = grid.to(torch.bfloat16)
    return grid.reshape(b, d0, d1, d2, c), count.reshape(b, d0, d1, d2)
