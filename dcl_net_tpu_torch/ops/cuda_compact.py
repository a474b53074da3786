"""K2: compaction of occupied voxels, and K5, its backward: hand-written
CUDA kernels (csrc/compact.cu).

Replace the Pallas kernels of dcl_net_tpu/ops/pallas_compact.py (forward and
custom-VJP backward). The output has no alignment gaps: it is bit-equal to
ops/sparse_conv.dense_to_sparse, so the overflow flag is the plain
``occupancy > capacity``. `dense_to_sparse` is the differentiable entry
point: an autograd Function whose forward is K2 and whose backward is K5,
with the gradient w.r.t. the features only (the mask is occupancy). A CUDA
tensor goes through the kernels, a CPU tensor through the plain versions;
there is no fallback.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops import sparse_conv

# Launches of K2 and of K5 since the last reset (set to 0 to reset).
launches = 0
bwd_launches = 0

BWD_TILE_BYTES = 16 * 1024  # K5 and K7 (ops/cuda_fused.py): output bytes per block
# K2's cells per block (csrc/compact.cu: 256, 512 or 1024), 4 cells a thread
TILE_CELLS = 1024
TILE_CHOICES = (256, 512, 1024)


def bwd_tile(c: int) -> int:
    """K5's cells per block: about BWD_TILE_BYTES of a [B, G, C] f32 grid
    (128 cells at C = 32, 16 at C = 256)."""
    return max(1, BWD_TILE_BYTES // (4 * c))


def dense_to_sparse_reference(
    feats: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: dense_to_sparse plus the per-sample occupancy [B] int32."""
    coords, vfeats, vmask = sparse_conv.dense_to_sparse(feats, mask, capacity)
    occupancy = (mask.reshape(mask.shape[0], -1) > 0).sum(1).to(torch.int32)
    return coords, vfeats, vmask, occupancy


def dense_to_sparse_cuda(
    feats: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first `capacity` occupied voxels of [B, D0, D1, D2, C] f32 feats
    (occupied = mask > 0, mask f32 [B, D0, D1, D2]) in linear-index order.

    Returns coords [B, cap, 3] int32, vfeats [B, cap, C], vmask [B, cap]
    (zero past the occupancy) and the occupancy [B] int32.

    One kernel entry point of two kernels on (cell tiles of TILE_CELLS, B)
    blocks: per-tile counts, then a writer that ranks its tile's cells from
    the counts before it and writes every element of the outputs, the zero
    tail included, so all four are allocated empty (the occupancy shares
    its buffer with the per-tile counts)."""
    global launches
    if feats.device.type == "cpu":
        return dense_to_sparse_reference(feats, mask, capacity)
    name = "dense_to_sparse_cuda"
    req = cuda_build.require
    req(feats.is_cuda, name, lambda: f"unsupported device {feats.device}")
    req(feats.dtype == torch.float32 and feats.dim() == 5, name,
        lambda: f"feats must be f32 [B, D0, D1, D2, C], got {feats.dtype} "
        f"{tuple(feats.shape)}")
    b, d0, d1, d2, c = feats.shape
    g = d0 * d1 * d2
    req(mask.dtype == torch.float32 and tuple(mask.shape) == (b, d0, d1, d2),
        name, lambda: f"mask must be f32 [{b}, {d0}, {d1}, {d2}]")
    req(mask.device == feats.device, name, "inputs on different devices")
    req(feats.is_contiguous() and mask.is_contiguous(), name,
        "inputs must be contiguous")
    req(0 < capacity <= g, name, lambda: f"capacity {capacity} outside [1, {g}]")
    req(b <= 65535, name, lambda: f"batch {b} above 65535 (the kernel's grid y)")
    tile = TILE_CELLS
    req(tile in TILE_CHOICES, name, lambda: f"TILE_CELLS {tile} not in {TILE_CHOICES}")
    dev = feats.device
    coords = torch.empty((b, capacity, 3), dtype=torch.int32, device=dev)
    vfeats = torch.empty((b, capacity, c), dtype=torch.float32, device=dev)
    vmask = torch.empty((b, capacity), dtype=torch.float32, device=dev)
    counts = torch.empty((b * (1 + -(-g // tile)),), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_compact", name, dev,
        feats.data_ptr(), mask.data_ptr(), coords.data_ptr(),
        vfeats.data_ptr(), vmask.data_ptr(), counts.data_ptr(),
        b, g, c, d1, d2, capacity, tile)
    launches += 1
    return coords, vfeats, vmask, counts[:b]


def dense_to_sparse_bwd_reference(dv: torch.Tensor, coords: torch.Tensor,
                                  vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """Plain version of K5: each valid slot's row of dv [B, cap, C] written
    back onto the grid cell coords [B, cap, 3] names, zeros elsewhere.
    Returns [B, D0, D1, D2, C]."""
    b, cap, c = dv.shape
    d0, d1, d2 = (int(d) for d in grid_shape)
    lin = (coords[..., 0].long() * d1 + coords[..., 1]) * d2 + coords[..., 2]
    rows = (lin + d0 * d1 * d2 * torch.arange(b, device=dv.device)[:, None])
    keep = (vmask > 0).reshape(-1)
    out = torch.zeros((b * d0 * d1 * d2, c), dtype=dv.dtype, device=dv.device)
    out[rows.reshape(-1)[keep]] = dv.reshape(-1, c)[keep]
    return out.reshape(b, d0, d1, d2, c)


def dense_to_sparse_bwd_cuda(dv: torch.Tensor, coords: torch.Tensor,
                             vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """K5: the grid gradient [B, D0, D1, D2, C] f32 of the compaction, from
    the cotangent dv [B, cap, C] of vfeats and the forward's coords, vmask.

    Precondition, which K2 (dense_to_sparse_cuda) and the plain
    sparse_conv.dense_to_sparse guarantee: the valid slots (vmask > 0) of a
    sample are a prefix and their linear indices rise strictly. One kernel
    launch writes the whole grid (allocated empty): each block owns
    `bwd_tile(C)` cells of one sample, stores their zeros, finds its slots
    by a search of that prefix and copies their rows in. Bound: the bytes
    of the grid, nearly all zeros. Bit-equal to the plain version."""
    global bwd_launches
    if dv.device.type == "cpu":
        return dense_to_sparse_bwd_reference(dv, coords, vmask, grid_shape)
    name = "dense_to_sparse_bwd_cuda"
    req = cuda_build.require
    req(dv.is_cuda, name, lambda: f"unsupported device {dv.device}")
    req(dv.dtype == torch.float32 and dv.dim() == 3, name,
        lambda: f"dv must be f32 [B, cap, C], got {dv.dtype} {tuple(dv.shape)}")
    b, cap, c = dv.shape
    req(coords.dtype == torch.int32 and tuple(coords.shape) == (b, cap, 3),
        name, lambda: f"coords must be int32 [{b}, {cap}, 3]")
    req(vmask.dtype == torch.float32 and tuple(vmask.shape) == (b, cap),
        name, lambda: f"vmask must be f32 [{b}, {cap}]")
    for t in (dv, coords, vmask):
        req(t.device == dv.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    d0, d1, d2 = (int(d) for d in grid_shape)
    g = d0 * d1 * d2
    req(0 < cap <= g, name, lambda: f"capacity {cap} outside [1, {g}]")
    req(b <= 65535, name, lambda: f"batch {b} above 65535 (the kernel's grid y)")
    dgrid = torch.empty((b, d0, d1, d2, c), dtype=torch.float32, device=dv.device)
    cuda_build.launch(
        "dclx_compact_bwd", name, dv.device,
        dv.data_ptr(), coords.data_ptr(), vmask.data_ptr(), dgrid.data_ptr(),
        b, g, c, d1, d2, cap, bwd_tile(c))
    bwd_launches += 1
    return dgrid


class DenseToSparse(torch.autograd.Function):
    """K2 forward, K5 backward. The backward reuses the forward's coords and
    vmask (no second scan); only the features get a gradient."""

    @staticmethod
    def forward(ctx, feats, mask, capacity):
        coords, vfeats, vmask, occupancy = dense_to_sparse_cuda(feats, mask, capacity)
        ctx.save_for_backward(coords, vmask)
        ctx.grid_shape = tuple(feats.shape[1:4])
        ctx.mark_non_differentiable(coords, vmask, occupancy)
        return coords, vfeats, vmask, occupancy

    @staticmethod
    def backward(ctx, _dcoords, dv, _dvmask, _docc):
        coords, vmask = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[0] and dv is not None:
            dfeats = dense_to_sparse_bwd_cuda(dv.contiguous(), coords, vmask,
                                              ctx.grid_shape)
        return dfeats, None, None


def dense_to_sparse(feats: torch.Tensor, mask: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable compaction (see dense_to_sparse_cuda)."""
    return DenseToSparse.apply(feats, mask, capacity)
