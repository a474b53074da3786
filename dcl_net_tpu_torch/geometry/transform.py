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


def untransform_points(points: torch.Tensor, rot: torch.Tensor,
                       trans: torch.Tensor) -> torch.Tensor:
    """Inverse pose: (points - t) @ R."""
    return (points - trans[..., None, :]) @ rot


def compose_pose(rot_outer, trans_outer, rot_inner, trans_inner):
    """The pose applying inner, then outer: R = R_o R_i, t = R_o t_i + t_o
    (the refiner's update t <- R dt + t, R <- R dR)."""
    rot = rot_outer @ rot_inner
    trans = (rot_outer @ trans_inner[..., None])[..., 0] + trans_outer
    return rot, trans


def invert_pose(rot, trans):
    """(R^T, -R^T t)."""
    rot_inv = rot.transpose(-1, -2)
    return rot_inv, -(rot_inv @ trans[..., None])[..., 0]


def l2_distance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-point L2 distance [..., N]."""
    return torch.linalg.norm(pred - target, dim=-1)


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., N, M] by |a|^2 - 2ab + |b|^2, clamped at 0.
    Each norm in its operand's type; the cross term in the two operands'
    promoted type (a bf16 prediction against f32 targets: f32), as JAX's
    einsum promotes them."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.clamp(a2 - 2.0 * (a.to(dt) @ b.to(dt).transpose(-1, -2)) + b2, min=0.0)


def chamfer_distance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer per point [..., N] (N == M):
    0.5 * (min_m |p_n - t_m| + min_n |p_n - t_m|)."""
    d = torch.sqrt(pairwise_sq_dist(pred, target) + 1e-12)
    return 0.5 * (d.amin(dim=-1) + d.amin(dim=-2))


def add_metric(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """ADD: mean L2 distance between identically indexed posed points."""
    return l2_distance(pred_pts, gt_pts).mean(dim=-1)


def adds_metric(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """ADD-S: mean distance of each predicted point to its nearest ground
    truth point (the symmetric-object metric)."""
    d = torch.sqrt(pairwise_sq_dist(pred_pts, gt_pts) + 1e-12)
    return d.amin(dim=-1).mean(dim=-1)
