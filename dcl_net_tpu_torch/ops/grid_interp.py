"""Local-window 3-NN interpolation straight from dense voxel grids (PyTorch).

Counterpart of dcl_net_tpu/ops/grid_interp.py, the point-feature path of
interp_mode "local": instead of compacting each level's occupied voxels
(K2) and searching them all (K3), each query point looks at the window^3
cells around its own cell and takes the 3 nearest occupied ones there. Its
own cell (in the reference's scale_list quirk coordinates) is occupied,
so the window holds at least one candidate; a neighbour more than
window // 2 cells away is missed, which the JAX package accepts as well.

The JAX function's details are kept, so the two agree on ties:
candidates in meshgrid-"ij" order of the offsets; the quirk cell
floor((p - offset) / (unit * scale)), clipped to the grid; candidates
outside the grid masked after clipping; squared distances as direct
differences to the centers, summed over x, y, z in that order; 1e10 for
an empty candidate; three passes of argmin, the lowest index first;
weights 1 / (d^2 + 1e-8), normalised; the weighted sum in the grid's type
(bf16 under a bf16 model).

Memory: the [B, N, W] candidate tensors are built one axis at a time, the
cells in int32, so no [B, N, W, 3] tensor exists (at batch 512, N 1024
and W 125 that is 786 MB in f32); each call's temporaries are freed when
it returns, before the next level's. The gradient reaches the grid
through the final gather (autograd's scatter-add), as JAX differentiates
its take_along_axis.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e10


def _window_offsets(window: int) -> np.ndarray:
    r = np.arange(window) - window // 2
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


def local_grid_interpolate(
    points: torch.Tensor,      # [B, N, 3] metric query points
    grid_feats: torch.Tensor,  # [B, D0, D1, D2, C]
    grid_mask: torch.Tensor,   # [B, D0, D1, D2]
    unit_voxel_extent,         # base unit extent (3,)
    scale: float,              # the level's scale_list entry
    offset,                    # metric corner of the volume (3,)
    window: int = 5,
) -> torch.Tensor:
    """3-NN inverse-squared-distance interpolation over a window^3
    neighbourhood of each point's cell: [B, N, C] in the grid's type."""
    b, n, _ = points.shape
    dims = tuple(int(d) for d in grid_feats.shape[1:4])
    c = grid_feats.shape[-1]
    dev = points.device
    su = np.asarray(unit_voxel_extent, np.float32) * float(scale)
    off = np.asarray(offset, np.float32)
    shift = off + 0.5 * su
    su_t, off_t = (torch.as_tensor(a, device=dev) for a in (su, off))
    hi = torch.tensor([d - 1 for d in dims], dtype=torch.int32, device=dev)
    base = torch.floor((points - off_t) / su_t).to(torch.int32)
    base = torch.minimum(torch.clamp(base, min=0), hi)               # [B, N, 3]
    offs = torch.as_tensor(_window_offsets(window), dtype=torch.int32, device=dev)
    w = offs.shape[0]

    lin = torch.zeros((b, n, w), dtype=torch.int32, device=dev)
    inb = torch.ones((b, n, w), dtype=torch.bool, device=dev)
    # f32 centers, as JAX's; the distances in the points' type (f64 points: f64)
    d2 = torch.zeros((b, n, w), dtype=torch.promote_types(points.dtype, torch.float32),
                     device=dev)
    for a, d in enumerate(dims):
        cand = base[..., a, None] + offs[:, a]                        # [B, N, W]
        inb &= (cand >= 0) & (cand < d)
        cand.clamp_(0, d - 1)
        lin.mul_(d).add_(cand)
        diff = points[..., a, None] - (cand.to(torch.float32) * float(su[a]) + float(shift[a]))
        d2 += diff * diff
        del cand, diff

    g = dims[0] * dims[1] * dims[2]
    occ = torch.gather(grid_mask.reshape(b, g), 1, lin.reshape(b, n * w).long())
    occ = occ.reshape(b, n, w) * inb.to(grid_mask.dtype)
    del inb
    d2 = torch.where(occ > 0, d2, torch.full((), BIG, dtype=d2.dtype, device=dev))
    del occ

    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2.scatter_(-1, i, BIG)
    del d2
    dist3 = torch.cat(dists, -1)                                      # [B, N, 3]
    recip = 1.0 / (dist3 + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)

    lin3 = torch.gather(lin, -1, torch.cat(idxs, -1)).long()          # [B, N, 3]
    del lin
    gathered = torch.gather(grid_feats.reshape(b, g, c), 1,
                            lin3.reshape(b, n * 3, 1).expand(-1, -1, c)).reshape(b, n, 3, c)
    if grid_feats.dtype == torch.bfloat16:
        # JAX's bf16 einsum: bf16 operands (the weights rounded to bf16),
        # products summed in f32, the result rounded to bf16 once
        wb = weight.to(torch.bfloat16).to(torch.float32)
        return torch.einsum("bnkc,bnk->bnc", gathered.float(), wb).to(torch.bfloat16)
    return torch.einsum("bnkc,bnk->bnc", gathered, weight.to(grid_feats.dtype))
