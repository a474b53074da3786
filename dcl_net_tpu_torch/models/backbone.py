"""Sparse-conv backbone and multi-scale voxel -> point interpolation (PyTorch).

Counterpart of dcl_net_tpu/models/backbone.py. Dims
(7,16,32,32,64,64,128,128,256): 8 conv blocks in 4 modules, the first of
each module regular (dilating), the second submanifold, each module closed
by a true-average pool (kernel 3, stride 2). Grids 64^3 -> 32^3 -> 16^3 ->
8^3 -> 4^3; the pyramid is the 4 pooled levels.

At each level the occupied voxels are compacted (kernel K2,
ops/cuda_compact.py) and interpolated back onto the points by 3-NN (kernel
K3, ops/cuda_interp.py): 32+64+128+256 = 480 channels per point.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dcl_net_tpu_torch.models.blocks import SparseConvBlock
from dcl_net_tpu_torch.ops.cuda_compact import dense_to_sparse_cuda
from dcl_net_tpu_torch.ops.cuda_interp import nn_interpolate_cuda
from dcl_net_tpu_torch.ops.sparse_conv import sparse_avg_pool, voxel_centers


class SparseBackbone(nn.Module):
    """4-module sparse conv pyramid returning 4 pooled (feats, mask) levels."""

    def __init__(self, dims: Sequence[int] = (7, 16, 32, 32, 64, 64, 128, 128, 256),
                 stride_layers: Sequence[int] = (1, 3, 5), kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.module_end = set(stride_layers) | {len(dims) - 2}
        for i in range(len(dims) - 1):
            subm = not ((i - 1) in stride_layers or i == 0)
            self.add_module(f"conv{i}", SparseConvBlock(
                dims[i], dims[i + 1], kernel_size, subm=subm))
        self.n_layers = len(dims) - 1

    def forward(self, grid: torch.Tensor, mask: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        outputs = []
        x, m = grid, mask
        for i in range(self.n_layers):
            x, m = getattr(self, f"conv{i}")(x, m)
            if i in self.module_end:
                x, m = sparse_avg_pool(x, m, self.kernel_size, 2)
                outputs.append((x, m))
        return outputs


class MultiScalePointFeatures(nn.Module):
    """Interpolate the 4 pyramid levels onto the query points and concat.

    Voxel centers use the reference's scale_list quirk (2, 4, 6, 8), though
    the pooled grids sit at strides (2, 4, 8, 16). capacities are the
    per-level occupied-voxel budgets, capped at the level's grid size; a
    sample whose occupancy exceeds one is flagged in the overflow output."""

    def __init__(self, unit_voxel_extent: Sequence[float] = (0.006,) * 3,
                 voxel_num_limit: Sequence[int] = (64, 64, 64),
                 scale_list: Sequence[int] = (2, 4, 6, 8),
                 capacities: Sequence[int] = (2048, 1024, 512, 64)):
        super().__init__()
        self.unit = np.asarray(unit_voxel_extent, np.float32)
        limit = np.asarray(voxel_num_limit, np.float32)
        self.offset = -0.5 * self.unit * limit
        self.scale_list = tuple(scale_list)
        self.capacities = tuple(int(c) for c in capacities)

    def forward(self, points: torch.Tensor,
                pyramid: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points [B, N, 3] -> (features [B, N, 480], overflow [B] bool)."""
        feats_all = []
        overflow = torch.zeros(points.shape[0], dtype=torch.bool,
                               device=points.device)
        for level, (feats, mask) in enumerate(pyramid):
            grid_n = int(np.prod(feats.shape[1:4]))
            cap = min(self.capacities[level], grid_n)
            coords, vfeats, vmask, occupancy = dense_to_sparse_cuda(
                feats.contiguous(), mask.contiguous(), cap)
            overflow = overflow | (occupancy > cap)
            centers = voxel_centers(coords, self.unit, self.scale_list[level],
                                    self.offset)
            interp, _, _ = nn_interpolate_cuda(points, centers, vfeats, vmask)
            feats_all.append(interp)
        return torch.cat(feats_all, dim=-1), overflow
