"""Building blocks: masked sparse-conv blocks and per-point MLPs (PyTorch).

Counterpart of dcl_net_tpu/models/blocks.py. Grids stay channel-last
[B, D0, D1, D2, C] and point features [B, N, C]; only F.conv3d sees a
[B, C, D0, D1, D2] view (channels_last_3d in memory, so no copy).

This slice runs inference: the blocks normalise with their running
statistics, and the sparse-conv block folds them into its kernel. Training
mode raises until the training slice ports batch statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dcl_net_tpu_torch.ops.sparse_conv import (
    dilate_mask,
    masked_batch_norm_stats,
)

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": lambda x: x,
}


def _inference_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} runs in eval mode only (call .eval()); "
            "training-mode batch statistics come with the training port")


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose statistics run over occupied voxels only: biased
    variance to normalise, unbiased for the running update, momentum 0.1
    (flax 0.9), eps 1e-5. Parameters follow nn.BatchNorm1d's names."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = masked_batch_norm_stats(x.to(torch.float32), mask)
            with torch.no_grad():
                m = torch.clamp(mask.to(torch.float32).sum(), min=2.0)
                unbiased = var * m / (m - 1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class SparseConvBlock(nn.Module):
    """Sparse conv (no bias, stride 1, pad k//2) + BN + ReLU on a masked
    dense grid. subm=True keeps the active set; subm=False is a regular
    sparse conv whose active set dilates by the kernel footprint.

    In eval mode the BN running statistics fold into the conv
    (w' = w * s, b' = beta - mean * s, s = gamma / sqrt(var + eps)): one
    conv, then ReLU, then the re-mask that keeps inactive voxels at zero.
    Input invariant: x is zero at inactive voxels."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 subm: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.subm = subm
        self.conv = nn.Conv3d(in_features, features, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _inference_only(self)
        k = self.kernel_size
        new_mask = mask if self.subm else dilate_mask(mask, k)
        s = self.bn.weight / torch.sqrt(self.bn.running_var + self.bn.eps)
        w_eff = self.conv.weight * s[:, None, None, None, None]
        b_eff = self.bn.bias - self.bn.running_mean * s
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w_eff, padding=k // 2)
        y = y.permute(0, 2, 3, 4, 1) + b_eff
        y = torch.relu(y) * new_mask[..., None].to(y.dtype)
        return y, new_mask


class PointMLP(nn.Module):
    """Per-point MLP over [B, N, C]: Linear, then BN and activation in either
    order. bn_before_act=True is the disengage block's ordering
    (BasicBlock_3DCONV); False is the heads' (act, then BN).

    Submodules are named Dense_i and BatchNorm_j, the JAX parameter tree's
    names, so weights map across one to one (weights.py)."""

    def __init__(self, in_dim: int, dims: Sequence[int], acts: Sequence[str],
                 bns: Sequence[bool], bn_before_act: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.acts = tuple(acts)
        self.bn_before_act = bn_before_act
        self.bn_index = []
        n_bn = 0
        for i, (dim, bn) in enumerate(zip(dims, bns)):
            self.add_module(f"Dense_{i}", nn.Linear(in_dim, dim, bias=use_bias))
            if bn:
                self.add_module(f"BatchNorm_{n_bn}", nn.BatchNorm1d(dim, eps=1e-5))
                self.bn_index.append(n_bn)
                n_bn += 1
            else:
                self.bn_index.append(None)
            in_dim = dim

    def _bn(self, j: int, x: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, f"BatchNorm_{j}")
        # flax's order of operations: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return (x - bn.running_mean) * mul + bn.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _inference_only(self)
        for i, (act, j) in enumerate(zip(self.acts, self.bn_index)):
            x = getattr(self, f"Dense_{i}")(x)
            if self.bn_before_act:
                if j is not None:
                    x = self._bn(j, x)
                x = _ACTS[act](x)
            else:
                x = _ACTS[act](x)
                if j is not None:
                    x = self._bn(j, x)
        return x
