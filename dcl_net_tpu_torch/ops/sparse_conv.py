"""Sparse-3D-conv semantics on dense masked grids (plain PyTorch).

Counterpart of dcl_net_tpu/ops/sparse_conv.py: a submanifold conv is a dense
conv over masked features re-masked by the input mask, a regular stride-1
sparse conv dilates the mask by the kernel footprint, the sparse average
pool divides a window sum by the window's occupied count, and batch-norm
statistics run over occupied voxels only. Grids are channel-last
[B, D0, D1, D2, C]; masks are [B, D0, D1, D2].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """[B, D0, D1, D2, C] -> [B, C, D0, D1, D2] as a view (channels_last_3d)."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def window_sum(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """k^3 box sum with zero padding of a channel-last grid [B, D0, D1, D2, C].

    The zero padding is explicit because avg_pool3d refuses inputs smaller
    than the kernel (the 2^3 level of a 16^3 grid) even when padded."""
    xp = F.pad(_ncdhw(x), (padding,) * 6)
    return _ndhwc(F.avg_pool3d(xp, kernel, stride, divisor_override=1))


def dilate_mask(mask: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Kernel-footprint dilation (stride 1, pad k//2) of an occupancy mask:
    the active output set of a regular sparse conv."""
    m = (mask > 0).to(torch.float32)[:, None]
    d = F.max_pool3d(m, kernel, 1, kernel // 2)[:, 0]
    return d.to(mask.dtype)


def sparse_avg_pool(feats: torch.Tensor, mask: torch.Tensor, kernel: int = 3,
                    stride: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """True-average sparse pooling (use_gs=False, padding k//2): the window
    sum of occupied features over the window's occupied count. Returns the
    pooled features [B, D', D', D', C] (zero where empty) and mask."""
    pad = kernel // 2
    m = mask.to(feats.dtype)
    s = window_sum(feats * m[..., None], kernel, stride, pad)
    cnt = window_sum(m[..., None], kernel, stride, pad)[..., 0]
    new_mask = (cnt > 0).to(mask.dtype)
    out = s / torch.clamp(cnt, min=1.0)[..., None]
    return out * new_mask[..., None].to(feats.dtype), new_mask


def masked_batch_norm_stats(feats: torch.Tensor, mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over occupied voxels only.
    feats [B, ..., C]; mask [B, ...]."""
    m = mask.to(feats.dtype)[..., None]
    denom = torch.clamp(m.sum(), min=1.0)
    axes = tuple(range(feats.dim() - 1))
    mean = (feats * m).sum(dim=axes) / denom
    var = (m * (feats - mean) ** 2).sum(dim=axes) / denom
    return mean, var


def dense_to_sparse(feats: torch.Tensor, mask: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first `capacity` occupied voxels (mask > 0) of each sample, in
    linear-index order, as coords [B, V, 3] int32, vfeats [B, V, C] and
    vmask [B, V]; padding rows are zero. Occupied voxels past the capacity
    are dropped.

    A stable sort of the vacancy flags puts occupied cells first in index
    order, as the top_k of dcl_net_tpu/ops/sparse_conv.dense_to_sparse does
    for a 0/1 mask."""
    b = feats.shape[0]
    d0, d1, d2 = feats.shape[1:4]
    c = feats.shape[-1]
    g = d0 * d1 * d2
    occ = mask.reshape(b, g) > 0
    lin = torch.argsort((~occ).to(torch.uint8), dim=1, stable=True)[:, :capacity]
    vmask = torch.gather(occ, 1, lin).to(feats.dtype)
    vfeats = torch.gather(feats.reshape(b, g, c), 1,
                          lin[..., None].expand(-1, -1, c)) * vmask[..., None]
    i0 = lin // (d1 * d2)
    rem = lin % (d1 * d2)
    coords = torch.stack([i0, rem // d2, rem % d2], dim=-1).to(torch.int32)
    coords = coords * vmask[..., None].to(torch.int32)
    return coords, vfeats, vmask


def voxel_center_affine(unit_voxel_extent, scale: float, offset
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(unit * scale, offset + 0.5 * unit * scale) as f32 [3] arrays: the
    affine map from voxel coordinates to metric centers at a scale."""
    unit = np.asarray(unit_voxel_extent, dtype=np.float32) * float(scale)
    shift = np.asarray(offset, dtype=np.float32) + 0.5 * unit
    return unit, shift


def voxel_centers(coords: torch.Tensor, unit_voxel_extent, scale: float,
                  offset) -> torch.Tensor:
    """Metric voxel centers at a pyramid scale:
    ``idx * (unit * scale) + offset + 0.5 * (unit * scale)``."""
    unit, shift = voxel_center_affine(unit_voxel_extent, scale, offset)
    unit_t = torch.as_tensor(unit, device=coords.device)
    shift_t = torch.as_tensor(shift, device=coords.device)
    return coords.to(torch.float32) * unit_t + shift_t
