"""Building blocks: masked sparse-conv blocks and per-point MLPs (PyTorch).

Counterpart of dcl_net_tpu/models/blocks.py. Grids stay channel-last
[B, D0, D1, D2, C] and point features [B, N, C]; only F.conv3d sees a
[B, C, D0, D1, D2] view (channels_last_3d in memory, so no copy).

In eval mode the blocks normalise with their running statistics, and the
sparse-conv block folds them into its kernel. In train mode (module.train())
they normalise with batch statistics that the gradient flows through and
update the running statistics in place, as the JAX blocks do under
train=True with mutable batch_stats: the sparse-conv block over occupied
voxels (MaskedBatchNorm), the per-point MLPs as flax's nn.BatchNorm.
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


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """BN statistics run in at least f32 (f64 stays f64), as flax's do."""
    return torch.promote_types(x.dtype, torch.float32)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Draw a model's weights from a torch.Generator seeded with `seed`:
    lecun-normal conv and dense kernels, zero biases, identity BN
    parameters and statistics."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=gen) / fan_in ** 0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm1d, MaskedBatchNorm)):
            mod.reset_parameters()


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

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = masked_batch_norm_stats(x.to(_stat_dtype(x)), mask)
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
    In train mode the conv output is normalised by MaskedBatchNorm over the
    voxels active after the conv (dcl_net_tpu/models/blocks.py:130-145).
    Input invariant: x is zero at inactive voxels."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 subm: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.subm = subm
        self.conv = nn.Conv3d(in_features, features, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        k = self.kernel_size
        new_mask = mask if self.subm else dilate_mask(mask, k)
        if self.training:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.conv.weight, padding=k // 2)
            y = self.bn(y.permute(0, 2, 3, 4, 1), new_mask)
        else:
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
    names, so weights map across one to one (weights.py).

    The BN follows flax's nn.BatchNorm, not F.batch_norm: in train mode the
    statistics reduce over every axis but the last, the variance is
    E[x^2] - E[x]^2 clipped at 0 (flax's use_fast_variance), and the
    running variance is updated with that biased variance (momentum 0.1,
    flax's 0.9); then (x - mean) * (rsqrt(var + eps) * scale) + bias."""

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
        if self.training:
            axes = tuple(range(x.dim() - 1))
            xf = x.to(_stat_dtype(x))
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
                bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        # flax's order of operations: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean) * mul + bn.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
