"""K3: masked 3-NN interpolation, and K4, its backward: hand-written CUDA
kernels (csrc/interp.cu).

Replace the Pallas kernels of dcl_net_tpu/ops/pallas_interp.py (forward and
custom-VJP backward). `nn_interpolate` is the differentiable entry point:
an autograd Function whose forward is K3 and whose backward is K4, with the
gradient w.r.t. the features only, as the JAX custom VJP gives. A CUDA
tensor goes through the kernels, a CPU tensor through the plain versions;
there is no fallback.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops.knn import BIG, iterated_argmin

# Launches of K3 and of K4 since the last reset (set to 0 to reset).
launches = 0
bwd_launches = 0


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
    req(points.is_cuda, name, lambda: f"unsupported device {points.device}")
    req(points.dim() == 3 and points.shape[-1] == 3, name,
        lambda: f"points must be [B, N, 3], got {tuple(points.shape)}")
    b, n, _ = points.shape
    req(feats.dim() == 3 and feats.shape[0] == b, name,
        lambda: f"feats must be [{b}, V, C], got {tuple(feats.shape)}")
    v, c = feats.shape[1], feats.shape[2]
    req(v > 0, name, "no centers")
    req(tuple(centers.shape) == (b, v, 3), name, lambda: f"centers must be [{b}, {v}, 3]")
    req(tuple(mask.shape) == (b, v), name, lambda: f"mask must be [{b}, {v}]")
    for t in (points, centers, feats, mask):
        req(t.dtype == torch.float32, name, lambda: f"inputs must be f32, got {t.dtype}")
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


def nn_interpolate_bwd_reference(g: torch.Tensor, w: torch.Tensor,
                                 idx: torch.Tensor, v: int) -> torch.Tensor:
    """Plain version of K4: dfeats[b, idx[b,k,t], :] += w[b,k,t] * g[b,t,:].

    g [B, N, C]; w, idx [B, 3, N] as K3 writes them. Returns [B, V, C]."""
    b, n, c = g.shape
    terms = w[..., None] * g[:, None, :, :]                     # [B, 3, N, C]
    rows = (idx.long() + v * torch.arange(b, device=g.device)[:, None, None])
    out = torch.zeros((b * v, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows.reshape(-1), terms.reshape(-1, c))
    return out.reshape(b, v, c)


def nn_interpolate_bwd_cuda(g: torch.Tensor, w: torch.Tensor,
                            idx: torch.Tensor, v: int) -> torch.Tensor:
    """K4: the features' gradient of the 3-NN interpolation, [B, V, C] f32,
    from the output cotangent g [B, N, C] and K3's w, idx [B, 3, N]."""
    global bwd_launches
    if g.device.type == "cpu":
        return nn_interpolate_bwd_reference(g, w, idx, v)
    name = "nn_interpolate_bwd_cuda"
    req = cuda_build.require
    req(g.is_cuda, name, lambda: f"unsupported device {g.device}")
    req(g.dtype == torch.float32 and g.dim() == 3, name,
        lambda: f"g must be f32 [B, N, C], got {g.dtype} {tuple(g.shape)}")
    b, n, c = g.shape
    req(w.dtype == torch.float32 and tuple(w.shape) == (b, 3, n), name,
        lambda: f"w must be f32 [{b}, 3, {n}]")
    req(idx.dtype == torch.int32 and tuple(idx.shape) == (b, 3, n), name,
        lambda: f"idx must be int32 [{b}, 3, {n}]")
    req(v > 0, name, "no centers")
    for t in (g, w, idx):
        req(t.device == g.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    dfeats = torch.zeros((b, v, c), dtype=torch.float32, device=g.device)
    cuda_build.launch(
        "dclx_interp_bwd", name, g.device,
        g.data_ptr(), w.data_ptr(), idx.data_ptr(), dfeats.data_ptr(),
        b, n, v, c)
    bwd_launches += 1
    return dfeats


class NNInterpolate(torch.autograd.Function):
    """K3 forward, K4 backward. Points, centers and mask get no gradient
    (None), as in dcl_net_tpu/ops/pallas_interp.py::_vjp_bwd: the points are
    data and the centers come from integer voxel coordinates."""

    @staticmethod
    def forward(ctx, points, centers, feats, mask):
        out, w, idx = nn_interpolate_cuda(points, centers, feats, mask)
        ctx.save_for_backward(w, idx)
        ctx.n_centers = feats.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        w, idx = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[2]:
            dfeats = nn_interpolate_bwd_cuda(g.contiguous(), w, idx, ctx.n_centers)
        return None, None, dfeats, None


def nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                   feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Differentiable 3-NN interpolation [B, N, C] (see nn_interpolate_cuda)."""
    return NNInterpolate.apply(points, centers, feats, mask)
