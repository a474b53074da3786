"""Rotation utilities that stage-1 inference needs (plain PyTorch).

Counterpart of dcl_net_tpu/geometry/rotation.py: vector normalisation and
the ortho-9D -> SO(3) projection by SVD with the determinant fix, polished
by two Newton-Schulz steps. Run in f32 with TF32 off (see
dcl_net_tpu_torch.strict_f32).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def normalize_vector(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """L2-normalise the last axis with a magnitude floor."""
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(mag, min=eps)


def ortho9d_to_matrix(x_raw: torch.Tensor, y_raw: torch.Tensor,
                      z_raw: torch.Tensor) -> torch.Tensor:
    """9D -> SO(3): normalise the three [B, 3] vectors, stack them as the
    columns of M and project to U diag(1, 1, det(U V^T)) V^T. Returns
    [B, 3, 3] rotations with det +1."""
    m = torch.stack([normalize_vector(x_raw), normalize_vector(y_raw),
                     normalize_vector(z_raw)], dim=-1)
    m = m.to(torch.promote_types(m.dtype, torch.float32))
    u, _, vh = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vh)
    sigma = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    r = (u * sigma[:, None, :]) @ vh
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    for _ in range(2):
        r = 0.5 * (r @ (3.0 * eye - r.transpose(-1, -2) @ r))
    return r
