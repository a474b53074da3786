"""K3: masked 3-NN interpolation, hand-written CUDA kernel (csrc/interp.cu).

Replaces the Pallas kernel of dcl_net_tpu/ops/pallas_interp.py. A CUDA
tensor goes through the kernel, a CPU tensor through the plain version;
there is no fallback.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops.knn import BIG, iterated_argmin

# Launches of the kernel since the last reset (set to 0 to reset).
launches = 0


def nn_interpolate_reference(
    points: torch.Tensor, centers: torch.Tensor, feats: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel.

    Squared distances by direct differences, summed over axes 0, 1, 2 in
    that order; masked centers at BIG; iterated-argmin top 3 (ties to the
    lowest index); w = recip * (1 / sum(recip)) with recip = 1/(d^2 + 1e-8).
    Returns out [B, N, C], w [B, 3, N] and idx [B, 3, N] int32."""
    diff = points[:, :, None, :] - centers[:, None, :, :]  # [B, N, V, 3]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    d2 = torch.where(mask[:, None, :] > 0, d2, torch.full_like(d2, BIG))
    dist, idx = iterated_argmin(d2, 3)
    recip = 1.0 / (dist + 1e-8)
    w = recip * (1.0 / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]))
    batch = torch.arange(points.shape[0], device=points.device)[:, None, None]
    terms = feats[batch, idx.long()] * w[..., None]  # [B, N, 3, C]
    out = (terms[:, :, 0] + terms[:, :, 1]) + terms[:, :, 2]
    return out, w.transpose(1, 2).contiguous(), idx.transpose(1, 2).contiguous()


def nn_interpolate_cuda(
    points: torch.Tensor, centers: torch.Tensor, feats: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3-NN inverse-squared-distance interpolation of [B, V, C] features at
    [B, V, 3] centers (valid where mask [B, V] > 0) onto [B, N, 3] points.

    All inputs f32 and contiguous. Returns out [B, N, C] and, for the
    backward, the weights w [B, 3, N] and indices idx [B, 3, N] int32."""
    global launches
    if points.device.type == "cpu":
        return nn_interpolate_reference(points, centers, feats, mask)
    name = "nn_interpolate_cuda"
    req = cuda_build.require
    req(points.is_cuda, name, f"unsupported device {points.device}")
    req(points.dim() == 3 and points.shape[-1] == 3, name,
        f"points must be [B, N, 3], got {tuple(points.shape)}")
    b, n, _ = points.shape
    req(feats.dim() == 3 and feats.shape[0] == b, name,
        f"feats must be [{b}, V, C], got {tuple(feats.shape)}")
    v, c = feats.shape[1], feats.shape[2]
    req(v > 0, name, "no centers")
    req(tuple(centers.shape) == (b, v, 3), name, f"centers must be [{b}, {v}, 3]")
    req(tuple(mask.shape) == (b, v), name, f"mask must be [{b}, {v}]")
    for t in (points, centers, feats, mask):
        req(t.dtype == torch.float32, name, f"inputs must be f32, got {t.dtype}")
        req(t.device == points.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    dev = points.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    w = torch.empty((b, 3, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, 3, n), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_interp", name, dev,
        points.data_ptr(), centers.data_ptr(), feats.data_ptr(),
        mask.data_ptr(), out.data_ptr(), w.data_ptr(), idx.data_ptr(),
        b, n, v, c)
    launches += 1
    return out, w, idx
