"""K2: compaction of occupied voxels, hand-written CUDA kernel (csrc/compact.cu).

Replaces the Pallas kernel of dcl_net_tpu/ops/pallas_compact.py. The output
has no alignment gaps: it is bit-equal to ops/sparse_conv.dense_to_sparse,
so the overflow flag is the plain ``occupancy > capacity``. A CUDA tensor
goes through the kernel, a CPU tensor through the plain version; there is
no fallback.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops.sparse_conv import dense_to_sparse

# Launches of the kernel since the last reset (set to 0 to reset).
launches = 0


def dense_to_sparse_reference(
    feats: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: dense_to_sparse plus the per-sample occupancy [B] int32."""
    coords, vfeats, vmask = dense_to_sparse(feats, mask, capacity)
    occupancy = (mask.reshape(mask.shape[0], -1) > 0).sum(1).to(torch.int32)
    return coords, vfeats, vmask, occupancy


def dense_to_sparse_cuda(
    feats: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first `capacity` occupied voxels of [B, D0, D1, D2, C] f32 feats
    (occupied = mask > 0, mask f32 [B, D0, D1, D2]) in linear-index order.

    Returns coords [B, cap, 3] int32, vfeats [B, cap, C], vmask [B, cap]
    (zero past the occupancy) and the occupancy [B] int32."""
    global launches
    if feats.device.type == "cpu":
        return dense_to_sparse_reference(feats, mask, capacity)
    name = "dense_to_sparse_cuda"
    req = cuda_build.require
    req(feats.is_cuda, name, f"unsupported device {feats.device}")
    req(feats.dtype == torch.float32 and feats.dim() == 5, name,
        f"feats must be f32 [B, D0, D1, D2, C], got {feats.dtype} "
        f"{tuple(feats.shape)}")
    b, d0, d1, d2, c = feats.shape
    g = d0 * d1 * d2
    req(mask.dtype == torch.float32 and tuple(mask.shape) == (b, d0, d1, d2),
        name, f"mask must be f32 [{b}, {d0}, {d1}, {d2}]")
    req(mask.device == feats.device, name, "inputs on different devices")
    req(feats.is_contiguous() and mask.is_contiguous(), name,
        "inputs must be contiguous")
    req(0 < capacity <= g, name, f"capacity {capacity} outside [1, {g}]")
    dev = feats.device
    coords = torch.zeros((b, capacity, 3), dtype=torch.int32, device=dev)
    vfeats = torch.zeros((b, capacity, c), dtype=torch.float32, device=dev)
    vmask = torch.zeros((b, capacity), dtype=torch.float32, device=dev)
    occupancy = torch.empty((b,), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_compact", name, dev,
        feats.data_ptr(), mask.data_ptr(), coords.data_ptr(),
        vfeats.data_ptr(), vmask.data_ptr(), occupancy.data_ptr(),
        b, g, c, d1, d2, capacity)
    launches += 1
    return coords, vfeats, vmask, occupancy
