"""Point-cloud voxelization on dense grids (plain PyTorch).

Counterpart of dcl_net_tpu/ops/voxelize.py, all five modes of the
reference's voxelizer: 0 = unique (a sum: each voxel holds at most one
point), 1 = first, 2 = last (the lowest or highest point index of each
voxel, masked points never winning), 3 = sum and 4 = mean (DCL-Net's
cfg.voxelization_mode = 4); and point_recover, which gathers grid rows back
to the points. The hand-written kernel K1 (ops/cuda_voxelize.py) runs modes
3 and 4, and mode 0 as its sum; the sums here are its plain version. Modes
1 and 2 are a scatter-min / scatter-max of point ids and one gather, on any
device, as the JAX package computes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MODE_UNIQUE = 0
MODE_FIRST = 1
MODE_LAST = 2
MODE_SUM = 3
MODE_MEAN = 4
MODES = (MODE_UNIQUE, MODE_FIRST, MODE_LAST, MODE_SUM, MODE_MEAN)


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
    """Scatter per-point features into a dense grid: a sum (modes 0 and 3),
    a mean (mode 4), or the features of each voxel's first or last point
    (modes 1 and 2, `_select_dense`).

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
    if mode not in MODES:
        raise NotImplementedError(f"voxelization mode {mode}")
    if mode in (MODE_FIRST, MODE_LAST):
        grid, count = _select_dense(feats, voxel_idx, grid_size, mode, point_mask)
        return (grid if out_dtype is None else grid.to(out_dtype)), count
    b, n, c = feats.shape
    d0, d1, d2 = (int(d) for d in grid_size)
    g = d0 * d1 * d2
    lin, alive = _linear(voxel_idx, grid_size)
    if point_mask is not None:
        alive = alive & (point_mask > 0)
    lin = lin + torch.arange(b, device=lin.device)[:, None] * g
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


def _linear(voxel_idx: torch.Tensor, grid_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major linear cell [B, N] (int64) of each point and whether its
    index lies inside the grid on every axis."""
    d0, d1, d2 = (int(d) for d in grid_size)
    idx = voxel_idx.long()
    limit = torch.tensor([d0, d1, d2], device=idx.device)
    inside = ((idx >= 0) & (idx < limit)).all(-1)
    return (idx[..., 0] * d1 + idx[..., 1]) * d2 + idx[..., 2], inside


def _select_dense(feats, voxel_idx, grid_size, mode, point_mask):
    """Modes 1 and 2: each voxel takes the features of its lowest (first)
    or highest (last) point id, by a scatter-min / scatter-max of the ids
    over a buffer filled with N (first) or -1 (last), then one gather. A
    masked point (or one outside the grid) takes the fill, so it never
    wins. Min and max are order-free: the result is deterministic on every
    device. Counts are those of the sum modes."""
    b, n, c = feats.shape
    d0, d1, d2 = (int(d) for d in grid_size)
    g = d0 * d1 * d2
    lin, alive = _linear(voxel_idx, grid_size)
    if point_mask is not None:
        alive = alive & (point_mask > 0)
    lin = torch.where(alive, lin, 0)
    fill = n if mode == MODE_FIRST else -1
    pid = torch.arange(n, dtype=torch.int64, device=feats.device).expand(b, n)
    pid = torch.where(alive, pid, fill)
    win = torch.full((b, g), fill, dtype=torch.int64, device=feats.device)
    win = win.scatter_reduce(1, lin, pid, "amin" if mode == MODE_FIRST else "amax",
                             include_self=True)
    has = (win < n) & (win >= 0)
    rows = torch.gather(feats, 1, win.clamp(0, n - 1)[..., None].expand(b, g, c))
    grid = torch.where(has[..., None], rows, torch.zeros((), dtype=feats.dtype,
                                                         device=feats.device))
    count = torch.zeros((b, g), dtype=torch.float32 if feats.dtype == torch.bfloat16
                        else feats.dtype, device=feats.device)
    count = count.scatter_add(1, lin, alive.to(count.dtype))
    return grid.reshape(b, d0, d1, d2, c), count.reshape(b, d0, d1, d2)


def point_recover(grid: torch.Tensor, voxel_idx: torch.Tensor) -> torch.Tensor:
    """Grid rows back to points: grid [B, D0, D1, D2, C] and voxel_idx
    [B, N, 3] -> [B, N, C], each point the row of its cell."""
    b, d0, d1, d2, c = grid.shape
    lin, _ = _linear(voxel_idx, (d0, d1, d2))
    flat = grid.reshape(b, d0 * d1 * d2, c)
    return torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))


# The reference op's name (pointgroup_ops.voxelization), as the JAX package has it.
voxelize = voxelize_dense
