"""Sparse-3D-conv semantics on dense masked grids (plain PyTorch).

Counterpart of dcl_net_tpu/ops/sparse_conv.py: a submanifold conv is a dense
conv over masked features re-masked by the input mask, a regular stride-1
sparse conv dilates the mask by the kernel footprint, the sparse average
pool divides a window sum by the window's occupied count, and batch-norm
statistics run over occupied voxels only. Grids are channel-last
[B, D0, D1, D2, C]; masks are [B, D0, D1, D2].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcl_net_tpu_torch.parallel.mesh import active, all_reduce_sum


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """[B, D0, D1, D2, C] -> [B, C, D0, D1, D2] as a view (channels_last_3d)."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


WINDOW_SUM_CHUNK = 1 << 30  # elements of one padded buffer of window_sum


def window_sum_rows(c: int, spatial, padding: int) -> int:
    """The samples of a [B, D0, D1, D2, c] grid whose zero-padded buffer holds
    at most WINDOW_SUM_CHUNK elements: window_sum sums a larger batch in
    chunks of that many."""
    d0, d1, d2 = (int(d) + 2 * padding for d in spatial)
    return max(1, WINDOW_SUM_CHUNK // (c * d0 * d1 * d2))


def window_sum(x: torch.Tensor, kernel: int, stride: int, padding: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k^3 box sum with zero padding of a channel-last grid [B, D0, D1, D2, C],
    of x * mask[..., None] where a mask [B, D0, D1, D2] is given.

    The zero padding is explicit because avg_pool3d refuses inputs smaller
    than the kernel (the 2^3 level of a 16^3 grid) even when padded. x (and
    the mask) are written straight into the interior of one zero-filled
    contiguous [B, C, ...] buffer, which avg_pool3d reads without a copy:
    one grid-sized temporary instead of three (the product, the pad and
    avg_pool3d's contiguous copy), which had been the largest of eval's
    temporaries at the configs' batch of 512 (PERF.md, section 6).

    A bf16 grid is summed as the JAX package sums it (dcl_net_tpu/ops/
    sparse_conv.py::_conv_window_sum): three separable k-tap passes, axis 0,
    then 1, then 2, each one a bf16 convolution whose sums XLA takes in f32
    and rounds to bf16, so the result is rounded three times. On the card
    each pass is avg_pool3d on the bf16 buffer, which sums in f32 and
    rounds its output to bf16; torch has no BFloat16 avg_pool3d on the CPU,
    so there each pass sums in f32 and is rounded to bf16 after it. Autograd
    differentiates the three passes, each backward pass rounded to bf16,
    which is where XLA rounds the transposes of its three bf16 convolutions
    (bit-equal to the JAX pool's gradient on the CPU).

    The batch is summed in chunks whose padded buffer holds at most
    WINDOW_SUM_CHUNK elements: a 64^3 level of 32 channels at batch 256
    holds 2^31 (the padded buffer more), past the 32-bit element indices
    that avg_pool3d's CUDA kernels take; the sums are per sample, so the
    chunks change no value."""
    b, d0, d1, d2, c = x.shape
    p = padding
    rows = window_sum_rows(c, (d0, d1, d2), p)
    if b > rows:
        return torch.cat([window_sum(x[i:i + rows], kernel, stride, padding,
                                     None if mask is None else mask[i:i + rows])
                          for i in range(0, b, rows)])
    xp = x.new_zeros((b, c, d0 + 2 * p, d1 + 2 * p, d2 + 2 * p))
    inner = xp[:, :, p:p + d0, p:p + d1, p:p + d2]
    inner.copy_(_ncdhw(x))
    if mask is not None:
        inner.mul_(mask[:, None])
    if x.dtype != torch.bfloat16:
        return _ndhwc(F.avg_pool3d(xp, kernel, stride, divisor_override=1))
    for axis in range(3):
        k, st = [1, 1, 1], [1, 1, 1]
        k[axis], st[axis] = kernel, stride
        if xp.is_cuda:
            xp = F.avg_pool3d(xp, k, st, divisor_override=1)
        else:
            xp = F.avg_pool3d(xp.float(), k, st, divisor_override=1).to(torch.bfloat16)
    return _ndhwc(xp)


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
    s = window_sum(feats, kernel, stride, pad, mask=m)
    cnt = window_sum(m[..., None], kernel, stride, pad)[..., 0]
    new_mask = (cnt > 0).to(mask.dtype)
    out = s / torch.clamp(cnt, min=1.0)[..., None]
    return out * new_mask[..., None].to(feats.dtype), new_mask


def masked_moments(feats: torch.Tensor, mask: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over occupied voxels only, and
    the count of occupied voxels (a 0-d tensor in feats' type).
    feats [B, ..., C]; mask [B, ...].

    Over a batch sharded across `group` (parallel/mesh.py) the statistics
    are the global batch's, in the same two-pass form: the masked sum and
    the count are all-reduced and give the mean, then the masked sum of
    squared deviations from that mean is all-reduced and gives the
    variance. Without a group no collective is taken."""
    m = mask.to(feats.dtype)[..., None]
    axes = tuple(range(feats.dim() - 1))
    count = m.sum()
    total = (feats * m).sum(dim=axes)
    if active(group):
        sums = all_reduce_sum(torch.cat([total, count[None]]), group)
        total, count = sums[:-1], sums[-1]
    denom = torch.clamp(count, min=1.0)
    mean = total / denom
    sq = all_reduce_sum((m * (feats - mean) ** 2).sum(dim=axes), group)
    return mean, sq / denom, count


def masked_batch_norm_stats(feats: torch.Tensor, mask: torch.Tensor, group=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over occupied voxels only
    (masked_moments without the count). feats [B, ..., C]; mask [B, ...]."""
    mean, var, _ = masked_moments(feats, mask, group)
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
    # vmask in the features' type; under bf16 features it stays f32, as the
    # JAX package's (K2's bf16 variant copies rows only)
    vmask_dtype = torch.float32 if feats.dtype == torch.bfloat16 else feats.dtype
    vmask = torch.gather(occ, 1, lin).to(vmask_dtype)
    vfeats = torch.gather(feats.reshape(b, g, c), 1,
                          lin[..., None].expand(-1, -1, c)) * vmask[..., None].to(feats.dtype)
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
