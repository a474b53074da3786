"""K6: the fused compaction -> 3-NN interpolation, and K7, its backward:
a hand-written CUDA kernel (csrc/fused.cu) and the K4 -> K5 kernels.

Replace the Pallas kernels of dcl_net_tpu/ops/pallas_fused.py (forward and
custom-VJP backward). The forward runs the compaction K2
(ops/cuda_compact.py), then K6, which interpolates straight from K2's
coords, decoding each voxel center in the kernel, so the [B, cap, 3]
centers tensor and the pass that writes it are never made. Its results are
bit-equal to K2 -> voxel_centers -> K3. The backward K7 is the
interpolation's backward K4 into the compacted rows, then the compaction's
backward K5 onto the grid, with the gradient w.r.t. the features only, as
in pallas_fused._vjp_bwd (whose scatter runs into cap rounded up to 8
rows: the port's compaction has no gaps, so it runs into cap rows).

`compact_interpolate` is the differentiable entry point. A CUDA tensor goes
through the kernels, a CPU tensor through the plain versions; there is no
fallback.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build, cuda_compact, cuda_interp

# Launches of K6 and of K7 since the last reset (set to 0 to reset).
launches = 0
bwd_launches = 0


def compact_interpolate_reference(
    points: torch.Tensor, coords: torch.Tensor, vfeats: torch.Tensor,
    vmask: torch.Tensor, occupancy: torch.Tensor, unit_s: Sequence[float],
    off_c: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K6: the centers coords * unit_s + off_c in f32 (one
    rounded product, one rounded sum), cast to the points' type, then the
    plain 3-NN interpolation. vmask carries the validity, which the
    occupancy repeats."""
    del occupancy
    unit = torch.tensor(tuple(unit_s), dtype=torch.float32, device=coords.device)
    off = torch.tensor(tuple(off_c), dtype=torch.float32, device=coords.device)
    centers = (coords.to(torch.float32) * unit + off).to(points.dtype)
    return cuda_interp.nn_interpolate_reference(points, centers, vfeats, vmask)


def compact_interpolate_cuda(
    points: torch.Tensor, coords: torch.Tensor, vfeats: torch.Tensor,
    vmask: torch.Tensor, occupancy: torch.Tensor, unit_s: Sequence[float],
    off_c: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3-NN inverse-squared-distance interpolation onto [B, N, 3] points of
    the compaction's output: coords [B, cap, 3] int32, vfeats [B, cap, C]
    f32, vmask [B, cap] f32 and occupancy [B] int32, as K2 writes them. The
    center of slot j is coords[j] * unit_s + off_c per axis (f32).

    Returns out [B, N, C] and, for the backward, w [B, 3, N] and idx
    [B, 3, N] int32."""
    global launches
    if points.device.type == "cpu":
        return compact_interpolate_reference(points, coords, vfeats, vmask,
                                             occupancy, unit_s, off_c)
    name = "compact_interpolate_cuda"
    req = cuda_build.require
    req(points.is_cuda, name, lambda: f"unsupported device {points.device}")
    req(points.dim() == 3 and points.shape[-1] == 3, name,
        lambda: f"points must be [B, N, 3], got {tuple(points.shape)}")
    b, n, _ = points.shape
    req(vfeats.dim() == 3 and vfeats.shape[0] == b, name,
        lambda: f"vfeats must be [{b}, cap, C], got {tuple(vfeats.shape)}")
    cap, c = vfeats.shape[1], vfeats.shape[2]
    req(cap > 0, name, "no slots")
    req(coords.dtype == torch.int32 and tuple(coords.shape) == (b, cap, 3), name,
        lambda: f"coords must be int32 [{b}, {cap}, 3]")
    req(occupancy.dtype == torch.int32 and tuple(occupancy.shape) == (b,), name,
        lambda: f"occupancy must be int32 [{b}]")
    req(tuple(vmask.shape) == (b, cap), name, lambda: f"vmask must be [{b}, {cap}]")
    for t in (points, vfeats, vmask):
        req(t.dtype == torch.float32, name,
            lambda: f"points, vfeats, vmask must be f32, got {t.dtype}")
    for t in (points, coords, vfeats, vmask, occupancy):
        req(t.device == points.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    req(len(unit_s) == 3 and len(off_c) == 3, name, "unit_s and off_c take 3 values")
    dev = points.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    w = torch.empty((b, 3, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, 3, n), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_compact_interp", name, dev,
        points.data_ptr(), coords.data_ptr(), vfeats.data_ptr(), vmask.data_ptr(),
        occupancy.data_ptr(), out.data_ptr(), w.data_ptr(), idx.data_ptr(),
        b, n, cap, c, *(float(u) for u in unit_s), *(float(o) for o in off_c))
    launches += 1
    return out, w, idx


def compact_interpolate_bwd_reference(g: torch.Tensor, w: torch.Tensor,
                                      idx: torch.Tensor, coords: torch.Tensor,
                                      vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """Plain version of K7: the plain K4 into [B, cap, C], then the plain
    K5 onto the grid. Returns [B, D0, D1, D2, C]."""
    dv = cuda_interp.nn_interpolate_bwd_reference(g, w, idx, coords.shape[1])
    return cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask, grid_shape)


def compact_interpolate_bwd_cuda(g: torch.Tensor, w: torch.Tensor,
                                 idx: torch.Tensor, coords: torch.Tensor,
                                 vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """K7: the grid gradient [B, D0, D1, D2, C] f32 of the fused op, from
    the output cotangent g [B, N, C], K6's w, idx [B, 3, N] and K2's coords,
    vmask: K4 (cuda_interp) into the compacted rows, then K5
    (cuda_compact) onto the grid. Each wrapper checks its own inputs.

    Replaces pallas_fused._vjp_bwd, which ran the interpolation's
    backward kernel into cap8 rows and then the compaction's backward. Bound
    on an H100: bytes (g, w and idx read once, the [B, G, C] grid written
    once, nearly all of it zero fill). The design keeps the TPU's two
    stages and their [B, cap, C] round trip between them, which is small
    beside the grid; each kernel's note (interp.cu, compact.cu) says what
    bounds it."""
    global bwd_launches
    if g.device.type == "cpu":
        return compact_interpolate_bwd_reference(g, w, idx, coords, vmask, grid_shape)
    dv = cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, coords.shape[1])
    dgrid = cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, grid_shape)
    bwd_launches += 1
    return dgrid


class CompactInterpolate(torch.autograd.Function):
    """K2 then K6 forward, K7 backward. Only the grid features get a
    gradient: the mask is occupancy, the points are data, and the centers
    come from integer voxel coordinates."""

    @staticmethod
    def forward(ctx, feats, mask, points, capacity, unit_s, off_c):
        coords, vfeats, vmask, occupancy = cuda_compact.dense_to_sparse_cuda(
            feats, mask, capacity)
        out, w, idx = compact_interpolate_cuda(points, coords, vfeats, vmask,
                                               occupancy, unit_s, off_c)
        ctx.save_for_backward(coords, vmask, w, idx)
        ctx.grid_shape = tuple(feats.shape[1:4])
        ctx.mark_non_differentiable(occupancy)
        return out, occupancy

    @staticmethod
    def backward(ctx, g, _docc):
        coords, vmask, w, idx = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[0]:
            dfeats = compact_interpolate_bwd_cuda(g.contiguous(), w, idx, coords,
                                                  vmask, ctx.grid_shape)
        return dfeats, None, None, None, None, None


def compact_interpolate(feats: torch.Tensor, mask: torch.Tensor,
                        points: torch.Tensor, capacity: int,
                        unit_s: Sequence[float], off_c: Sequence[float]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused compaction and interpolation of a [B, D0, D1,
    D2, C] grid (occupied where mask [B, D0, D1, D2] > 0, at most
    `capacity` voxels kept, in index order) onto [B, N, 3] points. Returns
    (out [B, N, C], occupancy [B] int32)."""
    return CompactInterpolate.apply(feats, mask, points, capacity,
                                    tuple(unit_s), tuple(off_c))
