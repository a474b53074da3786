"""K6: the fused compaction -> 3-NN interpolation, and K7, its backward:
hand-written CUDA kernels (csrc/fused.cu, with csrc/inverse_index.cuh).

Replace the Pallas kernels of dcl_net_tpu/ops/pallas_fused.py (forward and
custom-VJP backward). The forward runs the compaction K2
(ops/cuda_compact.py), then K6, which is K3's kernel (ops/cuda_interp.py,
the same block shape: SCAN_LANES, QUERIES) reading K2's coords and decoding
each voxel center in shared memory, so the [B, cap, 3] centers tensor and
the pass that writes it are never made. Its results are bit-equal to K2 ->
voxel_centers -> K3. The backward K7 computes what
pallas_fused._vjp_bwd does, the interpolation's backward into the
compacted rows and then the compaction's backward onto the grid, with the
gradient w.r.t. the features only, in one entry point that writes the grid
directly: no [B, cap, C] intermediate (the TPU's ran into cap rounded up to
8 rows; the port's compaction has no gaps).

`compact_interpolate` is the differentiable entry point. A CUDA tensor goes
through the kernels, a CPU tensor through the plain versions; there is no
fallback.

bf16 grids (model.compute_dtype: bfloat16) go through K2's and K6's bf16
variants: K6 reads K2's bf16 rows, keeps the centers, distances, w and idx
in f32 and rounds the weighted sum to bf16 once, torch.equal to K2 ->
centers -> K3 in bf16. A bf16 cotangent goes through K7's bf16 variant:
K4's f32 sums of the widened g, each rounded to bf16 once, then copied onto
a bf16 grid, as pallas_fused's backward does. Each variant has its own
launch count (`launches_bf16`, `bwd_launches_bf16`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build, cuda_compact, cuda_interp

# Launches of K6, of K7 and of their bf16 variants since the last reset (set
# to 0 to reset).
launches = 0
launches_bf16 = 0
bwd_launches = 0
bwd_launches_bf16 = 0

# K7's blocks at least, where the grid has the cells for them: at the coarse
# levels, where nearly every cell is a slot, a slot's serial sum and not the
# zeros sets the time, so more blocks share it out.
BWD_MIN_BLOCKS = 2048


def bwd_tile(b: int, cells: int, c: int, itemsize: int = 4) -> int:
    """K7's grid cells per block of a [b, cells, c] grid of `itemsize`-byte
    elements: K5's tile (cuda_compact.bwd_tile), or fewer, down to one, so
    that at least BWD_MIN_BLOCKS blocks run (f32: 128 at [32, 32^3, 32]; 1
    at [32, 4^3, 256])."""
    return min(cuda_compact.bwd_tile(c, itemsize), max(1, b * cells // BWD_MIN_BLOCKS))


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
    """K6 through the op dclx::compact_interpolate (ops/library.py):
    `compact_interpolate_kernel` on a CUDA tensor, the plain version on a
    CPU one."""
    cuda_build.require_device(points, "compact_interpolate_cuda")
    return torch.ops.dclx.compact_interpolate(
        points, coords, vfeats, vmask, occupancy, [float(u) for u in unit_s],
        [float(o) for o in off_c])


def compact_interpolate_kernel(
    points: torch.Tensor, coords: torch.Tensor, vfeats: torch.Tensor,
    vmask: torch.Tensor, occupancy: torch.Tensor, unit_s: Sequence[float],
    off_c: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3-NN inverse-squared-distance interpolation onto [B, N, 3] points of
    the compaction's output: coords [B, cap, 3] int32, vfeats [B, cap, C]
    f32 or bf16 (the bf16 variant: out bf16), vmask [B, cap] f32 and
    occupancy [B] int32, as K2 writes them. The
    center of slot j is coords[j] * unit_s + off_c per axis (f32). The
    kernel scans only the slots [0, min(occupancy[b], cap)), K3's n_valid,
    so vmask must be 0 from there on (K2's output meets that).

    Returns out [B, N, C] and, for the backward, w [B, 3, N] and idx
    [B, 3, N] int32."""
    global launches, launches_bf16
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
    req(b <= 65535, name, lambda: f"batch {b} above 65535 (the kernel's grid y)")
    for t in (points, vmask):
        req(t.dtype == torch.float32, name,
            lambda: f"points, vmask must be f32, got {t.dtype}")
    req(vfeats.dtype in (torch.float32, torch.bfloat16), name,
        lambda: f"vfeats must be f32 or bf16, got {vfeats.dtype}")
    bf16 = vfeats.dtype == torch.bfloat16
    for t in (points, coords, vfeats, vmask, occupancy):
        req(t.device == points.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    req(len(unit_s) == 3 and len(off_c) == 3, name, "unit_s and off_c take 3 values")
    lanes, queries = cuda_interp.block_shape(name)
    dev = points.device
    out = torch.empty((b, n, c), dtype=vfeats.dtype, device=dev)
    w = torch.empty((b, 3, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, 3, n), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_compact_interp_bf16" if bf16 else "dclx_compact_interp", name, dev,
        points.data_ptr(), coords.data_ptr(), vfeats.data_ptr(), vmask.data_ptr(),
        occupancy.data_ptr(), out.data_ptr(), w.data_ptr(), idx.data_ptr(),
        b, n, cap, c, lanes, queries, *(float(u) for u in unit_s),
        *(float(o) for o in off_c))
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out, w, idx


def compact_interpolate_bwd_reference(g: torch.Tensor, w: torch.Tensor,
                                      idx: torch.Tensor, coords: torch.Tensor,
                                      vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """Plain version of K7: the plain K4 into [B, cap, C], then the plain
    K5 onto the grid (invalid slots dropped). Returns [B, D0, D1, D2, C] of
    g's type (bf16: K4's f32 sums rounded once, then copied)."""
    dv = cuda_interp.nn_interpolate_bwd_reference(g, w, idx, coords.shape[1])
    return cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask, grid_shape)


def compact_interpolate_bwd_cuda(g: torch.Tensor, w: torch.Tensor,
                                 idx: torch.Tensor, coords: torch.Tensor,
                                 vmask: torch.Tensor, grid_shape) -> torch.Tensor:
    """K7: the grid gradient [B, D0, D1, D2, C] of the fused op, of g's
    type, from the output cotangent g [B, N, C] (f32, or bf16: the bf16
    variant), K6's w, idx [B, 3, N] and K2's coords [B, cap, 3], vmask
    [B, cap].

    Replaces pallas_fused._vjp_bwd. Precondition, as K5's (K2 and the plain
    sparse_conv.dense_to_sparse guarantee it): the valid slots of a sample
    are a prefix and their linear indices rise strictly. One kernel entry
    point: the inverse index (shared with K4) into an int32 scratch, then
    one launch writes the whole grid (allocated empty), each block a tile of
    cells of one sample: zeros, then each valid slot's ordered sum at its
    cell. Bound: the bytes of the grid, nearly all zeros. Bit-equal to the
    plain version on the CPU, and deterministic."""
    global bwd_launches, bwd_launches_bf16
    name = "compact_interpolate_bwd_cuda"
    cuda_compact.refuse_f16_cotangent(name, g)
    if g.device.type == "cpu":
        return compact_interpolate_bwd_reference(g, w, idx, coords, vmask, grid_shape)
    b, n, c = cuda_interp.check_bwd_inputs(name, g, w, idx)
    req = cuda_build.require
    req(coords.dim() == 3 and coords.shape[0] == b, name,
        lambda: f"coords must be int32 [{b}, cap, 3], got {tuple(coords.shape)}")
    cap = coords.shape[1]
    req(coords.dtype == torch.int32 and tuple(coords.shape) == (b, cap, 3), name,
        lambda: f"coords must be int32 [{b}, {cap}, 3]")
    req(vmask.dtype == torch.float32 and tuple(vmask.shape) == (b, cap), name,
        lambda: f"vmask must be f32 [{b}, {cap}]")
    for t in (coords, vmask):
        req(t.device == g.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    d0, d1, d2 = (int(d) for d in grid_shape)
    cells = d0 * d1 * d2
    req(0 < cap <= cells, name, lambda: f"capacity {cap} outside [1, {cells}]")
    dev = g.device
    bf16 = g.dtype == torch.bfloat16
    dgrid = torch.empty((b, d0, d1, d2, c), dtype=g.dtype, device=dev)
    scratch = torch.empty(cuda_interp.index_scratch_words(b, n, cap), dtype=torch.int32,
                          device=dev)
    cuda_build.launch(
        "dclx_compact_interp_bwd_bf16" if bf16 else "dclx_compact_interp_bwd", name, dev,
        g.data_ptr(), w.data_ptr(), idx.data_ptr(), coords.data_ptr(), vmask.data_ptr(),
        dgrid.data_ptr(), scratch.data_ptr(),
        b, n, cap, cells, c, d1, d2, bwd_tile(b, cells, c, g.element_size()))
    if bf16:
        bwd_launches_bf16 += 1
    else:
        bwd_launches += 1
    return dgrid


class CompactInterpolate(torch.autograd.Function):
    """K2 then K6 forward, K7 backward. Only the grid features get a
    gradient, in their type: the mask is occupancy, the points are data,
    and the centers come from integer voxel coordinates."""

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
