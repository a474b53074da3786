"""The forward kernels K1, K2, K3 and K6 as torch.library custom ops.

Four ops in the namespace ``dclx``, so that torch's tracer (torch.export,
serving.py) records each kernel as one node instead of tracing into its
wrapper, whose ctypes launch a FakeTensor cannot take:

  dclx::voxelize             K1 (ops/cuda_voxelize.py)
  dclx::dense_to_sparse      K2 (ops/cuda_compact.py)
  dclx::nn_interpolate       K3 (ops/cuda_interp.py)
  dclx::compact_interpolate  K6 (ops/cuda_fused.py)

Each op has two implementations: on the CPU the kernel's plain version, on
CUDA the kernel's launch, with its checks and its launch counts. No other
device has one, so a CUDA tensor launches the kernel or raises, as before.
The fake implementations give the shapes and types the kernels
write, also for a symbolic batch. K1 takes its output type (None: the
features'); K2, K3 and K6 write their input rows' type, so the bf16
variants are the same ops.

The wrappers (voxelize_cuda, dense_to_sparse_cuda, nn_interpolate_cuda,
compact_interpolate_cuda) call these ops; the package registers them on
import (ops/__init__.py). dclx::voxelize has an autograd formula with
respect to the features (cuda_voxelize.voxelize_vjp, stock torch on every
device, as the JAX package's VJP is XLA). The backward kernels K4, K5 and
K7 are called by the autograd Functions directly: no served graph runs
them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor

from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize

OPS = ("voxelize", "dense_to_sparse", "nn_interpolate", "compact_interpolate")


# ---- K1 ----------------------------------------------------------------------
@torch.library.custom_op("dclx::voxelize", mutates_args=(), device_types="cpu")
def voxelize(feats: Tensor, voxel_idx: Tensor, grid_size: List[int], mode: int,
             point_mask: Optional[Tensor], out_dtype: Optional[torch.dtype]
             ) -> Tuple[Tensor, Tensor]:
    """K1: grid [B, D0, D1, D2, C] of out_dtype (None: the features') and
    f32 counts [B, D0, D1, D2]."""
    grid, count = cuda_voxelize.voxelize_reference(feats, voxel_idx, grid_size, mode,
                                                   point_mask, out_dtype)
    # the plain version's counts (and in mode 3 its grid) are strided views of
    # one buffer: the kernel's outputs are dense, and an op's may not alias
    return grid.contiguous(), count.contiguous()


@voxelize.register_kernel("cuda")
def _voxelize_cuda(feats, voxel_idx, grid_size, mode, point_mask, out_dtype):
    return cuda_voxelize.voxelize_kernel(feats, voxel_idx, grid_size, mode, point_mask,
                                         out_dtype)


@voxelize.register_fake
def _voxelize_fake(feats, voxel_idx, grid_size, mode, point_mask, out_dtype):
    b, _, c = feats.shape
    d0, d1, d2 = grid_size
    return (feats.new_empty((b, d0, d1, d2, c), dtype=out_dtype or feats.dtype),
            feats.new_empty((b, d0, d1, d2), dtype=torch.float32))


def _voxelize_setup_context(ctx, inputs, output):
    _, voxel_idx, grid_size, mode, point_mask, _ = inputs
    ctx.save_for_backward(voxel_idx, point_mask, output[1])
    ctx.grid_size, ctx.mode, ctx.feats_dtype = tuple(grid_size), int(mode), inputs[0].dtype


def _voxelize_backward(ctx, g_grid, g_count):
    # the counts are integer-valued in the features: no gradient, nor for
    # the indices and the mask (the JAX VJP's zeros)
    voxel_idx, point_mask, count = ctx.saved_tensors
    return (cuda_voxelize.voxelize_vjp(g_grid, count, voxel_idx, point_mask, ctx.grid_size,
                                       ctx.mode, ctx.feats_dtype),
            None, None, None, None, None)


voxelize.register_autograd(_voxelize_backward, setup_context=_voxelize_setup_context)


# ---- K2 ----------------------------------------------------------------------
@torch.library.custom_op("dclx::dense_to_sparse", mutates_args=(), device_types="cpu")
def dense_to_sparse(feats: Tensor, mask: Tensor, capacity: int
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K2: coords [B, cap, 3] int32, rows [B, cap, C] of the features' type,
    vmask [B, cap] f32 and the occupancy [B] int32."""
    return cuda_compact.dense_to_sparse_reference(feats, mask, capacity)


@dense_to_sparse.register_kernel("cuda")
def _dense_to_sparse_cuda(feats, mask, capacity):
    return cuda_compact.dense_to_sparse_kernel(feats, mask, capacity)


@dense_to_sparse.register_fake
def _dense_to_sparse_fake(feats, mask, capacity):
    b, c = feats.shape[0], feats.shape[-1]
    return (feats.new_empty((b, capacity, 3), dtype=torch.int32),
            feats.new_empty((b, capacity, c)),
            feats.new_empty((b, capacity), dtype=torch.float32),
            feats.new_empty((b,), dtype=torch.int32))


# ---- K3 and K6 -----------------------------------------------------------------
def _interp_fake(points: Tensor, feats: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """out [B, N, C] of the rows' type, w [B, 3, N] f32, idx [B, 3, N] int32."""
    b, n, _ = points.shape
    return (feats.new_empty((b, n, feats.shape[-1])),
            points.new_empty((b, 3, n), dtype=torch.float32),
            points.new_empty((b, 3, n), dtype=torch.int32))


@torch.library.custom_op("dclx::nn_interpolate", mutates_args=(), device_types="cpu")
def nn_interpolate(points: Tensor, centers: Tensor, feats: Tensor, mask: Tensor,
                   n_valid: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """K3: out [B, N, C], w [B, 3, N] and idx [B, 3, N] int32."""
    return cuda_interp.nn_interpolate_reference(points, centers, feats, mask, n_valid)


@nn_interpolate.register_kernel("cuda")
def _nn_interpolate_cuda(points, centers, feats, mask, n_valid):
    return cuda_interp.nn_interpolate_kernel(points, centers, feats, mask, n_valid)


@nn_interpolate.register_fake
def _nn_interpolate_fake(points, centers, feats, mask, n_valid):
    return _interp_fake(points, feats)


@torch.library.custom_op("dclx::compact_interpolate", mutates_args=(),
                         device_types="cpu")
def compact_interpolate(points: Tensor, coords: Tensor, vfeats: Tensor, vmask: Tensor,
                        occupancy: Tensor, unit_s: List[float], off_c: List[float]
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K6: out [B, N, C], w [B, 3, N] and idx [B, 3, N] int32 from K2's
    output and the level's center affine (unit_s, off_c)."""
    return cuda_fused.compact_interpolate_reference(points, coords, vfeats, vmask,
                                                    occupancy, unit_s, off_c)


@compact_interpolate.register_kernel("cuda")
def _compact_interpolate_cuda(points, coords, vfeats, vmask, occupancy, unit_s, off_c):
    return cuda_fused.compact_interpolate_kernel(points, coords, vfeats, vmask, occupancy,
                                                 unit_s, off_c)


@compact_interpolate.register_fake
def _compact_interpolate_fake(points, coords, vfeats, vmask, occupancy, unit_s, off_c):
    return _interp_fake(points, vfeats)
