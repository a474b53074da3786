"""Rigid transforms and point-set distances (plain PyTorch).

Counterpart of dcl_net_tpu/geometry/transform.py. Points are row vectors
[..., N, 3]; a pose (R, t) acts as ``p @ R^T + t``.
"""

from __future__ import annotations

import torch


def transform_points(points: torch.Tensor, rot: torch.Tensor,
                     trans: torch.Tensor) -> torch.Tensor:
    """Apply a pose: points [..., N, 3], rot [..., 3, 3], trans [..., 3]."""
    return points @ rot.transpose(-1, -2) + trans[..., None, :]


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., N, M] by |a|^2 - 2ab + |b|^2, clamped at 0."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    return torch.clamp(a2 - 2.0 * (a @ b.transpose(-1, -2)) + b2, min=0.0)
