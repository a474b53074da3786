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

bf16 features (model.compute_dtype: bfloat16) go through K2's bf16
variant, which copies the bf16 rows as they are; coords, vmask and the
occupancy are the f32 variant's. A bf16 cotangent goes through K5's bf16
variant, which copies the bf16 rows onto a bf16 grid bit for bit. Each
variant has its own launch count (`launches_bf16`, `bwd_launches_bf16`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops import sparse_conv

# Launches of K2, of K5 and of their bf16 variants since the last reset
# (set to 0 to reset).
launches = 0
launches_bf16 = 0
bwd_launches = 0
bwd_launches_bf16 = 0

BWD_TILE_BYTES = 16 * 1024  # K5 and K7 (ops/cuda_fused.py): output bytes per block
# K2's cells per block (csrc/compact.cu: 256, 512 or 1024), 4 cells a thread
TILE_CELLS = 1024
TILE_CHOICES = (256, 512, 1024)


def bwd_tile(c: int, itemsize: int = 4) -> int:
    """K5's cells per block: about BWD_TILE_BYTES of a [B, G, C] grid of
    `itemsize`-byte elements (f32: 128 cells at C = 32, 16 at C = 256; bf16
    twice as many)."""
    return max(1, BWD_TILE_BYTES // (itemsize * c))


def refuse_f16_cotangent(name: str, g: torch.Tensor) -> None:
    """Raise ValueError for a float16 cotangent, on every device: the
    backward kernels (K4, K5, K7) have an f32 and a bf16 variant, the model
    no float16 path, and no cotangent may run on a converted copy."""
    cuda_build.require(g.dtype != torch.float16, name,
                       "float16 cotangent: the backward kernels run f32 or bf16")


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
    """K2 through the op dclx::dense_to_sparse (ops/library.py):
    `dense_to_sparse_kernel` on a CUDA tensor, the plain version on a CPU
    one."""
    cuda_build.require_device(feats, "dense_to_sparse_cuda")
    return torch.ops.dclx.dense_to_sparse(feats, mask, int(capacity))


def dense_to_sparse_kernel(
    feats: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first `capacity` occupied voxels of [B, D0, D1, D2, C] feats, f32
    or bf16 (the bf16 variant), (occupied = mask > 0, mask f32 [B, D0, D1,
    D2]) in linear-index order.

    Returns coords [B, cap, 3] int32, vfeats [B, cap, C] of the feats' type,
    vmask [B, cap] f32 (zero past the occupancy) and the occupancy [B]
    int32.

    One kernel entry point of two kernels on (cell tiles of TILE_CELLS, B)
    blocks: per-tile counts, then a writer that ranks its tile's cells from
    the counts before it and writes every element of the outputs, the zero
    tail included, so all four are allocated empty (the occupancy shares
    its buffer with the per-tile counts)."""
    global launches, launches_bf16
    name = "dense_to_sparse_cuda"
    req = cuda_build.require
    req(feats.is_cuda, name, lambda: f"unsupported device {feats.device}")
    req(feats.dtype in (torch.float32, torch.bfloat16) and feats.dim() == 5, name,
        lambda: f"feats must be f32 or bf16 [B, D0, D1, D2, C], got {feats.dtype} "
        f"{tuple(feats.shape)}")
    bf16 = feats.dtype == torch.bfloat16
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
    vfeats = torch.empty((b, capacity, c), dtype=feats.dtype, device=dev)
    vmask = torch.empty((b, capacity), dtype=torch.float32, device=dev)
    counts = torch.empty((b * (1 + -(-g // tile)),), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_compact_bf16" if bf16 else "dclx_compact", name, dev,
        feats.data_ptr(), mask.data_ptr(), coords.data_ptr(),
        vfeats.data_ptr(), vmask.data_ptr(), counts.data_ptr(),
        b, g, c, d1, d2, capacity, tile)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return coords, vfeats, vmask, counts[:b]


def dense_to_sparse_bwd_reference(dv: torch.Tensor, coords: torch.Tensor,
                                  vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """Plain version of K5: each valid slot's row of dv [B, cap, C] written
    back onto the grid cell coords [B, cap, 3] names, zeros elsewhere.
    Returns [B, D0, D1, D2, C] of dv's type (a bf16 row is copied as it
    is)."""
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
    """K5: the grid gradient [B, D0, D1, D2, C] of the compaction, from the
    cotangent dv [B, cap, C] of vfeats and the forward's coords, vmask. dv
    is f32, or bf16 (the bf16 variant: a bf16 grid, the rows copied bit for
    bit).

    Precondition, which K2 (dense_to_sparse_cuda) and the plain
    sparse_conv.dense_to_sparse guarantee: the valid slots (vmask > 0) of a
    sample are a prefix and their linear indices rise strictly. One kernel
    launch writes the whole grid (allocated empty): each block owns
    `bwd_tile(C)` cells of one sample, stores their zeros, finds its slots
    by a search of that prefix and copies their rows in. Bound: the bytes
    of the grid, nearly all zeros. Bit-equal to the plain version."""
    global bwd_launches, bwd_launches_bf16
    name = "dense_to_sparse_bwd_cuda"
    refuse_f16_cotangent(name, dv)
    if dv.device.type == "cpu":
        return dense_to_sparse_bwd_reference(dv, coords, vmask, grid_shape)
    req = cuda_build.require
    req(dv.is_cuda, name, lambda: f"unsupported device {dv.device}")
    req(dv.dtype in (torch.float32, torch.bfloat16) and dv.dim() == 3, name,
        lambda: f"dv must be f32 or bf16 [B, cap, C], got {dv.dtype} {tuple(dv.shape)}")
    bf16 = dv.dtype == torch.bfloat16
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
    dgrid = torch.empty((b, d0, d1, d2, c), dtype=dv.dtype, device=dv.device)
    cuda_build.launch(
        "dclx_compact_bwd_bf16" if bf16 else "dclx_compact_bwd", name, dv.device,
        dv.data_ptr(), coords.data_ptr(), vmask.data_ptr(), dgrid.data_ptr(),
        b, g, c, d1, d2, cap, bwd_tile(c, dv.element_size()))
    if bf16:
        bwd_launches_bf16 += 1
    else:
        bwd_launches += 1
    return dgrid


class DenseToSparse(torch.autograd.Function):
    """K2 forward, K5 backward. The backward reuses the forward's coords and
    vmask (no second scan); only the features get a gradient, in their type
    (the kernel makes it so: autograd would cast another type silently)."""

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
