"""PointNet++ grouping and set-abstraction modules (plain PyTorch).

Counterpart of dcl_net_tpu/ops/pointnet_modules.py: ball-query, KNN and
global grouping, the multi-scale and single-scale set-abstraction modules
and the feature-propagation module. Channel-last throughout. The shared
MLPs are Dense (no bias) -> BatchNorm (flax's: momentum 0.9, i.e. torch's
0.1, eps 1e-5, statistics over every axis but the channels) -> ReLU, as
models/blocks.py::PointMLP computes them, and carry the flax tree's names
(mlp_{i}.Dense_{j}, mlp_{i}.BatchNorm_{j}; the FP module's MLP is
_SharedMLP_0), so weights.py carries a JAX {"params", "batch_stats"} tree
of each module across and back. Unlike flax, a torch module is built with
its input widths: `in_channels` is the width of the point features
(0 without them).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dcl_net_tpu_torch import resolve_device
from dcl_net_tpu_torch.models.blocks import PointMLP, init_weights
from dcl_net_tpu_torch.ops.knn import (
    ball_query,
    furthest_point_sample,
    gather_operation,
    grouping_operation,
    knn,
    nearest_neighbor_interpolate,
)


def _group(xyz, new_xyz, idx, feats, use_xyz):
    grouped_xyz = grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
    if feats is None:
        return grouped_xyz
    grouped_feats = grouping_operation(feats, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1)
    return grouped_feats


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int,
                    feats: Optional[torch.Tensor] = None, use_xyz: bool = True
                    ) -> torch.Tensor:
    """Ball-query neighbourhoods, centered on new_xyz: [B, S, nsample, 3(+C)]."""
    return _group(xyz, new_xyz, ball_query(radius, nsample, xyz, new_xyz), feats, use_xyz)


def knn_and_group(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                  feats: Optional[torch.Tensor] = None, use_xyz: bool = True
                  ) -> torch.Tensor:
    """KNN neighbourhoods, centered on new_xyz: [B, S, k, 3(+C)]."""
    _, idx = knn(k, new_xyz, xyz)
    return _group(xyz, new_xyz, idx, feats, use_xyz)


def group_all(xyz: torch.Tensor, feats: Optional[torch.Tensor], use_xyz: bool = True
              ) -> torch.Tensor:
    """One global group: [B, 1, N, 3(+C)]."""
    grouped = xyz[:, None]
    if feats is None:
        return grouped
    if use_xyz:
        return torch.cat([grouped, feats[:, None]], dim=-1)
    return feats[:, None]


def _SharedMLP(in_dim: int, dims: Sequence[int]) -> PointMLP:
    """Dense (no bias) -> BN -> ReLU per width in dims."""
    return PointMLP(in_dim, tuple(dims), ("relu",) * len(dims), (True,) * len(dims),
                    bn_before_act=True, use_bias=False)


class _PointnetModule(nn.Module):
    def _finish(self, device, seed: int) -> None:
        init_weights(self, seed)
        self.to(resolve_device(device))
        self.eval()


class PointnetSAModuleMSG(_PointnetModule):
    """Multi-scale-grouping set abstraction. npoint: the FPS sample count
    (None: one global group); per scale i: radii[i], nsamples[i], mlps[i].
    Returns (new_xyz [B, npoint, 3], features [B, npoint, sum of the MLPs'
    last widths]), each scale's MLP max-pooled over its neighbourhood."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 use_xyz: bool = True, in_channels: int = 0, device=None, seed: int = 0):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        in_dim = in_channels + (3 if use_xyz or not in_channels else 0)
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp_{i}", _SharedMLP(in_dim, mlp))
        self.n_scales = len(mlps)
        self._finish(device, seed)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.npoint is not None:
            new_xyz = gather_operation(xyz, furthest_point_sample(xyz, self.npoint))
        else:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        outs = []
        for i in range(self.n_scales):
            if self.npoint is not None:
                grouped = query_and_group(xyz, new_xyz, self.radii[i], self.nsamples[i],
                                          feats, self.use_xyz)
            else:
                grouped = group_all(xyz, feats, self.use_xyz)
            outs.append(getattr(self, f"mlp_{i}")(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointnetSAModule(PointnetSAModuleMSG):
    """Single-scale set abstraction: one radius, nsample and MLP."""

    def __init__(self, mlp: Sequence[int], npoint: Optional[int] = None,
                 radius: Optional[float] = None, nsample: Optional[int] = None,
                 use_xyz: bool = True, **kw):
        super().__init__(npoint=npoint, radii=[radius], nsamples=[nsample], mlps=[mlp],
                         use_xyz=use_xyz, **kw)


class PointnetFPModule(_PointnetModule):
    """Feature propagation: 3-NN interpolation of the known points'
    features onto the unknown points (or, without known points, the one
    global feature broadcast), concatenated with the unknown points' own
    features, then a shared MLP. in_channels: the widths of known_feats
    plus unknown_feats."""

    def __init__(self, mlp: Sequence[int], in_channels: int, device=None, seed: int = 0):
        super().__init__()
        self.add_module("_SharedMLP_0", _SharedMLP(in_channels, mlp))
        self._finish(device, seed)

    def forward(self, unknown: torch.Tensor, known: Optional[torch.Tensor],
                unknown_feats: Optional[torch.Tensor], known_feats: torch.Tensor
                ) -> torch.Tensor:
        if known is not None:
            interp = nearest_neighbor_interpolate(unknown, known, known_feats)
        else:
            interp = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                        known_feats.shape[-1])
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return getattr(self, "_SharedMLP_0")(interp)
