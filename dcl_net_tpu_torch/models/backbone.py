"""Sparse-conv backbone and multi-scale voxel -> point interpolation (PyTorch).

Counterpart of dcl_net_tpu/models/backbone.py. Dims
(7,16,32,32,64,64,128,128,256): 8 conv blocks in 4 modules, the first of
each module regular (dilating), the second submanifold, each module closed
by a true-average pool (kernel 3, stride 2). Grids 64^3 -> 32^3 -> 16^3 ->
8^3 -> 4^3; the pyramid is the 4 pooled levels. Training and the serving
artifacts run it densely over the masked grids; the eager eval-mode
forwards on the active sites alone, the same levels (SparseBackbone).

At each level the occupied voxels are compacted (kernel K2,
ops/cuda_compact.py) and interpolated back onto the points by 3-NN:
32+64+128+256 = 480 channels per point. interp_mode picks the
interpolation: "exact" and "pallas" (the JAX package's names for its XLA
and Pallas two-stage paths, one path here) build the voxel centers and run
kernel K3 (ops/cuda_interp.py) over K2's valid prefix (its occupancy);
"pallas_fused" runs kernel K6 (ops/cuda_fused.py), which decodes the
centers inside the kernel; "local" searches a window of cells around each
point straight on the dense pooled grid (ops/grid_interp.py, stock
PyTorch, no compaction, so it never overflows). In training the gradient
flows back through the interpolation (kernel K4) and the compaction
(kernel K5) onto the pooled grids; on the fused path the two run as its
backward, K7; on the local path autograd's scatter-add of the gathers.

With dtype bfloat16 (model.compute_dtype) the grids, the pooled levels and
the interpolated features are bf16 and K2, K3 and K6 run their bf16
variants, as K4, K5 and K7 do in the backward, whose gradients are bf16;
masks, occupancies, voxel centers and points stay f32.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dcl_net_tpu_torch.models.blocks import SparseConvBlock
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp
from dcl_net_tpu_torch.ops.grid_interp import local_grid_interpolate
from dcl_net_tpu_torch.ops.sparse_conv import (
    ActiveSet, avg_pool_rows, scatter_rows, site_rows, sparse_avg_pool,
    voxel_center_affine, window_sum_rows, window_table,
)
from dcl_net_tpu_torch.telemetry import span

# set while a serving module runs (serving.py): its backbones take the dense
# path, which torch.export can trace at a static shape
_DENSE = contextvars.ContextVar("dclx_dense_backbone", default=False)


@contextlib.contextmanager
def _dense_backbone():
    """The context in which every backbone takes its dense path."""
    token = _DENSE.set(True)
    try:
        yield
    finally:
        _DENSE.reset(token)


class SparseBackbone(nn.Module):
    """4-module sparse conv pyramid returning 4 pooled (feats, mask) levels.

    Two paths give the same levels. _forward_dense convolves and pools the
    whole masked grid (F.conv3d, window sums): it runs in training (masked
    batch statistics, remat, cuDNN's weight and input gradients), while
    torch.export traces, and inside the serving modules (serving.py), so
    an exported artifact and its direct module run the same static-shape
    graph. _forward_active runs every other forward, the eager eval-mode
    ones (Evaluator, Stage2Evaluator, the template caches, the CLIs): the
    blocks on the active sites alone, with a neighbour table a conv or pool
    (ops/sparse_conv.py), then each pooled level scattered into its dense
    grid, zero where inactive."""

    def __init__(self, dims: Sequence[int] = (7, 16, 32, 32, 64, 64, 128, 128, 256),
                 stride_layers: Sequence[int] = (1, 3, 5), kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dims = tuple(dims)
        self.kernel_size = kernel_size
        self.module_end = set(stride_layers) | {len(dims) - 2}
        for i in range(len(dims) - 1):
            subm = not ((i - 1) in stride_layers or i == 0)
            self.add_module(f"conv{i}", SparseConvBlock(
                dims[i], dims[i + 1], kernel_size, subm=subm, dtype=dtype))
        self.n_layers = len(dims) - 1

    def unchunked_batch(self, grid_shape: Sequence[int]) -> int:
        """The largest batch whose pools all run unchunked on a grid_shape
        input (ops/sparse_conv.py::window_sum_rows): past it a pool's
        window sums branch on the batch size."""
        k, pad = self.kernel_size, self.kernel_size // 2
        spatial, rows = tuple(int(d) for d in grid_shape), []
        for i in sorted(self.module_end):
            # the features' window sum (the counts' has one channel: more rows)
            rows.append(window_sum_rows(self.dims[i + 1], spatial, pad))
            spatial = tuple((d + 2 * pad - k) // 2 + 1 for d in spatial)
        return min(rows)

    def forward(self, grid: torch.Tensor, mask: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        if self.training or torch.compiler.is_compiling() or _DENSE.get():
            return self._forward_dense(grid, mask)
        return self._forward_active(grid, mask)

    def _forward_dense(self, grid: torch.Tensor, mask: torch.Tensor
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        outputs = []
        x, m = grid, mask
        for i in range(self.n_layers):
            x, m = getattr(self, f"conv{i}")(x, m)
            if i in self.module_end:
                x, m = sparse_avg_pool(x, m, self.kernel_size, 2)
                outputs.append((x, m))
        return outputs

    def _forward_active(self, grid: torch.Tensor, mask: torch.Tensor
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The eval-mode pyramid on active sites (the class docstring): the
        rulebook (_rulebook), then the blocks on rows, each conv a gather
        of its neighbour rows and GEMMs of a few taps each, each pool a
        window sum over the active count, each pooled level scattered into
        a zeroed dense grid."""
        with span("model.backbone.rulebook"):
            sets, steps = self._rulebook(mask)
        with span("model.backbone.active"):
            outputs = []
            rows = site_rows(grid, sets[0])
            for i, a, b, table in steps:
                if i is None:
                    rows = avg_pool_rows(rows, table, self.kernel_size)
                    outputs.append((scatter_rows(rows, sets[b]), sets[b].mask(mask.dtype)))
                else:
                    rows = getattr(self, f"conv{i}").forward_rows(rows, table)
        return outputs

    def _rulebook(self, mask: torch.Tensor):
        """The active sets and tables of the pyramid for the input mask.

        Every block's output set densely first, one channel: a regular conv
        dilates its input set, a submanifold conv keeps it, a pool keeps the
        cells whose window holds a site (ActiveSet.window_any). Then the
        sizes of all the sets, read on the host at once (the path's one
        host wait), each set's sites in raster order, and one table a
        distinct (input, output) pair. Returns (sets, steps), a step
        (block index, or None for a pool; input set; output set; table)."""
        k = self.kernel_size
        sets = [ActiveSet.of_mask(mask, k // 2)]
        pairs = []  # (block index or None, input set, output set)
        for i in range(self.n_layers):
            cur = len(sets) - 1
            if not getattr(self, f"conv{i}").subm:
                sets.append(sets[cur].window_any(k, 1))
            pairs.append((i, cur, len(sets) - 1))
            if i in self.module_end:
                sets.append(sets[-1].window_any(k, 2))
                pairs.append((None, len(sets) - 2, len(sets) - 1))
        for s, n in zip(sets, torch.cat([s.count() for s in sets]).tolist()):
            s.index(n)
        tables = {}
        for i, a, b in pairs:
            if (a, b) not in tables:
                tables[a, b] = window_table(sets[b], sets[a], k, 1 if i is not None else 2)
        return sets, [(i, a, b, tables[a, b]) for i, a, b in pairs]


class MultiScalePointFeatures(nn.Module):
    """Interpolate the 4 pyramid levels onto the query points and concat.

    Voxel centers use the reference's scale_list quirk (2, 4, 6, 8), though
    the pooled grids sit at strides (2, 4, 8, 16). capacities are the
    per-level occupied-voxel budgets, capped at the level's grid size; a
    sample whose occupancy exceeds one (occupancy > capacity, on every
    mode) is flagged in the overflow output. The per-level center maps live
    on the module's device as non-persistent buffers, so a forward copies
    nothing from the host; the fused kernel takes them as f32 scalars.

    interp_mode: "exact" or "pallas" (K2 + centers + K3), "pallas_fused"
    (K2 + K6), or "local" (ops/grid_interp.py over a window^3 of cells; the
    overflow flag stays False, as in the JAX package, which sets it on the
    compacting paths only). Any N is taken: there is no N % 128 gate."""

    MODES = ("exact", "pallas", "pallas_fused", "local")

    def __init__(self, unit_voxel_extent: Sequence[float] = (0.006,) * 3,
                 voxel_num_limit: Sequence[int] = (64, 64, 64),
                 scale_list: Sequence[int] = (2, 4, 6, 8),
                 capacities: Sequence[int] = (2048, 1024, 512, 64),
                 interp_mode: str = "exact", window: int = 5):
        super().__init__()
        if interp_mode not in self.MODES:
            raise ValueError(f"interp_mode {interp_mode!r}: one of {self.MODES}")
        self.interp_mode = interp_mode
        self.window = int(window)
        self.unit = np.asarray(unit_voxel_extent, np.float32)
        limit = np.asarray(voxel_num_limit, np.float32)
        self.offset = -0.5 * self.unit * limit
        self.scale_list = tuple(scale_list)
        self.capacities = tuple(int(c) for c in capacities)
        self.center_affine = []  # per level: (unit * scale, shift) as floats
        for level, scale in enumerate(self.scale_list):
            unit, shift = voxel_center_affine(self.unit, scale, self.offset)
            self.center_affine.append((tuple(map(float, unit)), tuple(map(float, shift))))
            self.register_buffer(f"center_unit{level}", torch.from_numpy(unit),
                                 persistent=False)
            self.register_buffer(f"center_shift{level}", torch.from_numpy(shift),
                                 persistent=False)

    def forward(self, points: torch.Tensor,
                pyramid: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points [B, N, 3] -> (features [B, N, 480], overflow [B] bool)."""
        feats_all = []
        overflow = torch.zeros(points.shape[0], dtype=torch.bool,
                               device=points.device)
        for level, (feats, mask) in enumerate(pyramid):
            if self.interp_mode == "local":
                feats_all.append(local_grid_interpolate(
                    points, feats, mask, self.unit, self.scale_list[level], self.offset,
                    self.window))
                continue
            grid_n = int(np.prod(feats.shape[1:4]))
            cap = min(self.capacities[level], grid_n)
            if self.interp_mode == "pallas_fused":
                interp, occupancy = cuda_fused.compact_interpolate(
                    feats.contiguous(), mask.contiguous(), points, cap,
                    *self.center_affine[level])
            else:
                coords, vfeats, vmask, occupancy = cuda_compact.dense_to_sparse(
                    feats.contiguous(), mask.contiguous(), cap)
                # f32 centers whatever the model's dtype, as voxel_centers gives
                centers = (coords.to(torch.float32)
                           * getattr(self, f"center_unit{level}").float()
                           + getattr(self, f"center_shift{level}").float()).to(points.dtype)
                # K3 scans only K2's valid prefix [0, min(occupancy, cap))
                interp = cuda_interp.nn_interpolate(points, centers, vfeats, vmask,
                                                    occupancy)
            overflow = overflow | (occupancy > cap)
            feats_all.append(interp)
        return torch.cat(feats_all, dim=-1), overflow
