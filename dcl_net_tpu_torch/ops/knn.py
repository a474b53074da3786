"""Point-cloud neighbourhood ops: KNN, 3-NN interpolation, gathers and
grouping, farthest point sampling and ball query (plain PyTorch).

Counterpart of dcl_net_tpu/ops/knn.py. Distances use the
|a|^2 - 2ab + |b|^2 expansion of geometry/transform.pairwise_sq_dist, as
the JAX package's XLA path does; the main path's kernel
(ops/cuda_interp.py) uses direct differences instead. The gathers'
gradients are autograd's scatter-adds; farthest point sampling is a loop
of npoint steps of tensor ops that never reads a value back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcl_net_tpu_torch.geometry.transform import pairwise_sq_dist

BIG = 1e10


def iterated_argmin(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k passes of argmin over the last axis, each knocking its minimum out
    to BIG: exact, with ties to the lowest index. With fewer than k entries
    below BIG the remaining passes return index 0 at distance BIG (argmin of
    an all-BIG row), as the JAX reference does."""
    cur = d2
    dists, idxs = [], []
    for _ in range(k):
        i = torch.argmin(cur, dim=-1, keepdim=True)
        dists.append(torch.gather(cur, -1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, BIG)
    return torch.cat(dists, -1), torch.cat(idxs, -1).to(torch.int32)


def knn(k: int, query: torch.Tensor, ref: torch.Tensor,
        ref_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs of each query: squared distances and int32 indices
    [B, N, k], ascending. query [B, N, 3]; ref [B, M, 3]; ref_mask [B, M]."""
    d2 = pairwise_sq_dist(query, ref)
    if ref_mask is not None:
        d2 = torch.where(ref_mask[:, None, :] > 0, d2, torch.full_like(d2, BIG))
    m = d2.shape[-1]
    k_eff = min(k, m)
    dist2, idx = iterated_argmin(d2, k_eff)
    if k_eff < k:  # fewer refs than k: repeat the nearest
        pad = k - k_eff
        dist2 = torch.cat([dist2] + [dist2[..., :1]] * pad, -1)
        idx = torch.cat([idx] + [idx[..., :1]] * pad, -1)
    return dist2, idx


def three_nn(query: torch.Tensor, ref: torch.Tensor,
             ref_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return knn(3, query, ref, ref_mask)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """sum_k weight[b, n, k] * feats[b, idx[b, n, k]]: [B, M, C] -> [B, N, C]."""
    b = feats.shape[0]
    batch = torch.arange(b, device=feats.device)[:, None, None]
    gathered = feats[batch, idx.long()]  # [B, N, 3, C]
    return torch.einsum("bnkc,bnk->bnc", gathered, weight)


def nearest_neighbor_interpolate(query: torch.Tensor, ref: torch.Tensor,
                                 ref_feats: torch.Tensor,
                                 ref_mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """3-NN inverse-squared-distance interpolation: weights 1/(d^2 + 1e-8),
    normalised to sum to 1. bf16 features are interpolated in f32 (the
    distances' type) and the result rounded to bf16 once."""
    dist2, idx = three_nn(query, ref, ref_mask)
    recip = 1.0 / (dist2 + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)
    if ref_feats.dtype == torch.bfloat16:
        return three_interpolate(ref_feats.to(weight.dtype), idx,
                                 weight).to(torch.bfloat16)
    return three_interpolate(ref_feats, idx, weight.to(ref_feats.dtype))


def gather_operation(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features at point indices: feats [B, N, C], idx [B, S] -> [B, S, C]."""
    c = feats.shape[-1]
    return torch.gather(feats, 1, idx.long()[..., None].expand(-1, -1, c))


def grouping_operation(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features grouped by neighbourhood indices: feats [B, N, C],
    idx [B, S, K] -> [B, S, K, C]."""
    b, s, k = idx.shape
    return gather_operation(feats, idx.reshape(b, s * k)).reshape(b, s, k, feats.shape[-1])


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative farthest point sampling: [B, npoint] int32 indices into
    xyz [B, N, 3]. Starts at index 0; each step takes the point farthest
    from those taken (the first of equal ones); a masked point is never
    taken (its distance is -BIG)."""
    b, n, _ = xyz.shape
    valid = (torch.ones((b, n), dtype=torch.bool, device=xyz.device) if mask is None
             else mask > 0)
    neg = torch.full((), -BIG, dtype=xyz.dtype, device=xyz.device)
    min_dist = torch.where(valid, torch.full((), BIG, dtype=xyz.dtype, device=xyz.device),
                           neg)
    last = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    out = []
    for _ in range(int(npoint)):
        out.append(last)
        p = torch.gather(xyz, 1, last[..., None].expand(-1, -1, 3))   # [B, 1, 3]
        diff = xyz - p
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        min_dist = torch.minimum(min_dist, torch.where(valid, d2, neg))
        last = torch.argmax(min_dist, dim=-1, keepdim=True)
    return torch.cat(out, dim=1).to(torch.int32)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first nsample points (by index) within `radius` of each center:
    xyz [B, N, 3], new_xyz [B, S, 3] -> [B, S, nsample] int32; the slots
    past the points found repeat the first index found (the first taken
    slot, index 0's rank, where none is)."""
    n = xyz.shape[1]
    d2 = pairwise_sq_dist(new_xyz, xyz)                                # [B, S, N]
    inside = d2 < radius * radius
    if mask is not None:
        inside = inside & (mask[:, None, :] > 0)
    arange = torch.arange(n, device=xyz.device)
    key = torch.where(inside, arange, n + arange)
    idx = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).indices
    found = torch.gather(inside, -1, idx)
    return torch.where(found, idx, idx[..., :1]).to(torch.int32)
