"""K1: point -> voxel scatter, hand-written CUDA kernel (csrc/voxelize.cu).

Replaces the Pallas kernel of dcl_net_tpu/ops/pallas_voxelize.py. A CUDA
tensor goes through the kernel; a CPU tensor goes through the plain version
(ops/voxelize.voxelize_dense). There is no fallback: a CUDA tensor that
cannot reach the kernel raises.

The kernel is one launch in which each block owns TILE contiguous cells of
one sample and writes them whole, zeros included; it sums each cell's
points in point order and divides as the plain version does, so the two
are bit-equal. Each block keeps the list of its tile's points in shared
memory. Where that list does not fit (N above about 6,200 at C = 7), the
rounds kernel takes the points in rounds and carries each cell's sum and
count across them in shared memory, with the same result; `plan` picks
the kernel, the tile and the round's length, for any N and C.

With out_dtype bfloat16 (model.compute_dtype: bfloat16) the kernel's bf16
variant writes a bf16 grid with the semantics of the JAX package's
pallas_voxelize(out_dtype=bfloat16): sums of the bf16-rounded features, in
f32, stored as bf16; mode 4 divides that bf16 sum by the count and rounds
again; the counts stay f32. It has its own launch count, `launches_bf16`.

The op is differentiable with respect to the features (`voxelize_vjp`, the
JAX package's custom VJP of pallas_voxelize): each point takes its voxel's
cotangent, in stock torch, as the JAX package takes it with XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops.voxelize import MODE_MEAN, MODE_SUM, _linear, voxelize_dense

# Launches of the kernel and of its bf16 variant since the last reset (set
# to 0 to reset).
launches = 0
launches_bf16 = 0

# The plain version: same function, plain PyTorch.
voxelize_reference = voxelize_dense

TILE = 2048  # grid cells per block: 56 KB of grid and 8 KB of counts at C = 7
# Shared memory a block may take on an H100 (232,448 bytes), less 1 KB for
# the kernel's static shared memory.
SMEM_LIMIT = 232448 - 1024
THREADS = 1024  # a block of either kernel (csrc/voxelize.cu: kThreads)
# The rounds kernel's channels a slice (csrc/voxelize.cu: cw), at most.
ROUND_CHANNELS = 256


class Plan(NamedTuple):
    """K1's launch for N points of C features: the kernel (round_len 0: the
    list kernel; else the rounds kernel, round_len list entries a round and
    cw channels a slice), its cells per block and its dynamic shared
    memory in bytes."""
    tile: int
    smem: int
    cw: int
    round_len: int


def list_smem_bytes(n: int, c: int) -> int:
    """Dynamic shared memory of the list kernel's block for N points of C
    features per sample: the in-tile list (a cell, a link and C features for
    each of at most N points) and each of the TILE cells' chain tail, 4
    bytes a word."""
    return 4 * (n * (2 + c) + TILE)


def plan(n: int, c: int) -> Plan:
    """K1's launch for N points of C features (see Plan). The list kernel
    where its list fits SMEM_LIMIT (the configs' N = 1024 at C = 7); else
    the rounds kernel: channels in slices of cw = min(C, ROUND_CHANNELS),
    TILE cells a block halved until the carried sums and counts ([tile, cw
    + 2] words) take at most half of SMEM_LIMIT, and as long a round as the
    rest holds (2 + cw words an entry), at most N."""
    if list_smem_bytes(n, c) <= SMEM_LIMIT:
        return Plan(TILE, list_smem_bytes(n, c), c, 0)
    cw = min(c, ROUND_CHANNELS)
    tile = TILE
    while tile > 1 and 4 * tile * (cw + 2) > SMEM_LIMIT // 2:
        tile //= 2
    carried = 4 * tile * (cw + 2)
    round_len = max(1, min(n, (SMEM_LIMIT - carried) // (4 * (2 + cw))))
    return Plan(tile, carried + 4 * round_len * (2 + cw), cw, round_len)


def voxelize_cuda(
    feats: torch.Tensor,
    voxel_idx: torch.Tensor,
    grid_size: Tuple[int, int, int],
    mode: int = MODE_MEAN,
    point_mask: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum (mode 3) or mean (mode 4) scatter of [B, N, C] point features into
    a [B, D0, D1, D2, C] grid, with exact f32 counts [B, D0, D1, D2], through
    the op dclx::voxelize (ops/library.py): `voxelize_kernel` on a CUDA
    tensor, the plain version on a CPU one.

    K1 computes modes 3 and 4 only; any other mode raises ValueError on
    every device. The model runs mode 0 (unique) as mode 3, the sum, as the
    JAX package computes it, and modes 1 and 2 through
    ops/voxelize.py::voxelize_dense, which no kernel computes in either
    package."""
    cuda_build.require_device(feats, "voxelize_cuda")
    cuda_build.require(mode in (MODE_SUM, MODE_MEAN), "voxelize_cuda",
                       lambda: f"mode {mode} (3 or 4 only)")
    return torch.ops.dclx.voxelize(feats, voxel_idx, [int(d) for d in grid_size],
                                   int(mode), point_mask, out_dtype)


def voxelize_kernel(
    feats: torch.Tensor,
    voxel_idx: torch.Tensor,
    grid_size: Tuple[int, int, int],
    mode: int = MODE_MEAN,
    point_mask: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch, dclx::voxelize on CUDA (see voxelize_cuda).

    feats f32 and voxel_idx int32 [B, N, 3], both contiguous; point_mask
    optional f32 [B, N]; out_dtype the grid's type, f32 (None) or bfloat16
    (the bf16 variant). Points outside the grid are dropped. Each cell sums
    its points in point order, then divides by max(count, 1): bit-equal to
    the plain version. One kernel launch writes both outputs whole (they
    are allocated empty); `plan` picks the kernel for N and C."""
    global launches, launches_bf16
    name = "voxelize_cuda"
    req = cuda_build.require
    req(feats.is_cuda, name, lambda: f"unsupported device {feats.device}")
    req(mode in (MODE_SUM, MODE_MEAN), name, lambda: f"mode {mode} (3 or 4 only)")
    req(feats.dtype == torch.float32 and feats.dim() == 3, name,
        lambda: f"feats must be f32 [B, N, C], got {feats.dtype} {tuple(feats.shape)}")
    bf16 = out_dtype == torch.bfloat16
    req(bf16 or out_dtype in (None, torch.float32), name,
        lambda: f"out_dtype {out_dtype}: float32 or bfloat16")
    b, n, c = feats.shape
    req(voxel_idx.dtype == torch.int32 and tuple(voxel_idx.shape) == (b, n, 3),
        name, lambda: f"voxel_idx must be int32 [{b}, {n}, 3]")
    tensors = [feats, voxel_idx]
    if point_mask is not None:
        req(point_mask.dtype == torch.float32
            and tuple(point_mask.shape) == (b, n), name,
            lambda: f"point_mask must be f32 [{b}, {n}]")
        tensors.append(point_mask)
    for t in tensors:
        req(t.device == feats.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    req(b <= 65535, name, lambda: f"batch {b} above 65535 (the kernel's grid y)")
    p = plan(n, c)
    d0, d1, d2 = (int(d) for d in grid_size)
    grid = torch.empty((b, d0, d1, d2, c),
                       dtype=torch.bfloat16 if bf16 else torch.float32,
                       device=feats.device)
    count = torch.empty((b, d0, d1, d2), dtype=torch.float32,
                        device=feats.device)
    cuda_build.launch(
        "dclx_voxelize_bf16" if bf16 else "dclx_voxelize", name, feats.device,
        feats.data_ptr(), voxel_idx.data_ptr(),
        None if point_mask is None else point_mask.data_ptr(),
        grid.data_ptr(), count.data_ptr(), b, n, c, d0, d1, d2,
        int(mode == MODE_MEAN), p.tile, p.smem, p.cw, p.round_len)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return grid, count


def voxelize_vjp(g_grid: torch.Tensor, count: torch.Tensor, voxel_idx: torch.Tensor,
                 point_mask: Optional[torch.Tensor], grid_size: Tuple[int, int, int],
                 mode: int, feats_dtype: torch.dtype) -> torch.Tensor:
    """The features' gradient [B, N, C] of K1 for the grid's cotangent
    g_grid [B, D0, D1, D2, C] (dcl_net_tpu/ops/pallas_voxelize.py:180-199):
    each point gathers its voxel's cotangent in f32, divided by max(count, 1)
    in mode 4 and multiplied by its point_mask, cast to the features' type.
    A point outside the grid, which the forward drops, gets zero. Stock
    torch on every device: the JAX package computes it with XLA."""
    b, n = voxel_idx.shape[:2]
    c = g_grid.shape[-1]
    flat = g_grid.reshape(b, -1, c).to(torch.float32)
    if mode == MODE_MEAN:
        flat = flat / torch.clamp(count.reshape(b, -1), min=1.0)[..., None]
    lin, inside = _linear(voxel_idx, grid_size)
    lin = torch.where(inside, lin, torch.zeros_like(lin))
    d = torch.gather(flat, 1, lin[..., None].expand(b, n, c))
    d = torch.where(inside[..., None], d, torch.zeros_like(d))
    if point_mask is not None:
        d = d * point_mask[..., None].to(torch.float32)
    return d.to(feats_dtype)
