"""Auxiliary ops shipped by the reference libraries (numpy and PyTorch).

Counterpart of dcl_net_tpu/ops/extras.py: its numpy functions (nms,
points_to_voxel, VoxelGenerator, ballquery_batch_p, bfs_cluster, get_iou)
are copied here as they are; its jnp functions (sparse_field_max_pool,
sec_mean, sec_min, sec_max, roipool) are torch functions.

These mirror components vendored in the reference but unused by the DCL-Net
pipeline itself — provided so a reference user finds the full surface:
- 3D/BEV NMS (reference libs/spconv/spconv/utils/__init__.py:21-64 +
  src/utils/nms.cu): rotated-free axis-aligned IoU NMS here.
- VoxelGenerator / points_to_voxel (reference spconv/utils/__init__.py:66-111,
  points_to_voxel_3d_np): point cloud -> fixed-capacity voxel tensors.
- SparseFieldMaxPool (reference libs/spconv/spconv/pool.py:107-195 +
  pool_ops.h:64-104): max pooling that selects per-FIELD by vector norm and
  copies the whole field of the winner (for equivariant features).
- ballquery_batch_p / sec_mean-style segment reductions
  (reference libs/pointgroup_ops/functions/pointgroup_ops.py:115-150,
  256-337).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------
def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
        pre_max_size: Optional[int] = None, post_max_size: Optional[int] = None
        ) -> np.ndarray:
    """Axis-aligned NMS over [N, 4] (x1, y1, x2, y2) boxes (host-side numpy).

    Exact semantics of the reference's non_max_suppression_cpu
    (libs/spconv/include/spconv/nms.h:30-76, pinned by
    tests/test_golden_nms.py against the compiled reference code):
    suppression fires at iou >= threshold (inclusive), areas are unclamped,
    and zero-overlap pairs never suppress (the w>0/h>0 guard)."""
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    boxes = boxes[order]
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        w = np.minimum(x2[i], x2[i + 1:]) - np.maximum(x1[i], x1[i + 1:])
        h = np.minimum(y2[i], y2[i + 1:]) - np.maximum(y1[i], y1[i + 1:])
        pos = (w > 0) & (h > 0)
        inter = np.where(pos, w * h, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / (areas[i] + areas[i + 1:] - inter)
        suppressed[i + 1:] |= pos & (iou >= iou_threshold)
    keep = np.asarray(keep, np.int64)
    if post_max_size is not None:
        keep = keep[:post_max_size]
    return keep


# ---------------------------------------------------------------------------
# VoxelGenerator
# ---------------------------------------------------------------------------
def points_to_voxel(
    points: np.ndarray,
    voxel_size,
    coors_range,
    max_points: int = 35,
    max_voxels: int = 20000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Point cloud -> padded voxel tensors (reference points_to_voxel_3d_np,
    spconv/utils/__init__.py:21-64).

    Returns (voxels [M, max_points, C], coords [M, 3] zyx, counts [M]).
    """
    voxel_size = np.asarray(voxel_size, np.float32)
    coors_range = np.asarray(coors_range, np.float32)
    grid = np.round((coors_range[3:] - coors_range[:3]) / voxel_size).astype(np.int64)
    c = points.shape[1]
    voxels = np.zeros((max_voxels, max_points, c), points.dtype)
    coords = np.zeros((max_voxels, 3), np.int64)
    counts = np.zeros(max_voxels, np.int64)
    voxel_map = {}
    for p in points:
        idx = np.floor((p[:3] - coors_range[:3]) / voxel_size).astype(np.int64)
        if (idx < 0).any() or (idx >= grid).any():
            continue
        key = tuple(idx)
        slot = voxel_map.get(key)
        if slot is None:
            if len(voxel_map) >= max_voxels:
                # the reference BREAKS the whole scan on overflow — later
                # points stop filling even existing voxels
                # (point2voxel.h:71-74; pinned by test_golden_point2voxel)
                break
            slot = len(voxel_map)
            voxel_map[key] = slot
            coords[slot] = idx[::-1]  # zyx like spconv
        if counts[slot] < max_points:
            voxels[slot, counts[slot]] = p
            counts[slot] += 1
    m = len(voxel_map)
    return voxels[:m], coords[:m], counts[:m]


class VoxelGenerator:
    """Stateful wrapper (reference VoxelGenerator, spconv/utils:66-111)."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels
        self.grid_size = np.round(
            (self.point_cloud_range[3:] - self.point_cloud_range[:3])
            / self.voxel_size
        ).astype(np.int64)

    def generate(self, points: np.ndarray):
        return points_to_voxel(
            points, self.voxel_size, self.point_cloud_range,
            self.max_num_points, self.max_voxels,
        )


# ---------------------------------------------------------------------------
# SparseFieldMaxPool
# ---------------------------------------------------------------------------
def sparse_field_max_pool(
    feats: torch.Tensor,   # [B, D, D, D, F, C] fields of C-dim vectors
    mask: torch.Tensor,    # [B, D, D, D]
    kernel: int = 3,
    stride: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Field max pool: per output voxel and field, the whole C-vector of
    the in-window voxel whose vector NORM is largest (the first such in
    window order), so equivariant features are selected per field, not
    per component; an output with no occupied voxel in its window is 0
    and unoccupied. Returns (pooled [B, D', D', D', F, C], new mask)."""
    d = feats.shape[1]
    pad = kernel // 2
    norms = torch.linalg.vector_norm(feats, dim=-1)            # [B, D, D, D, F]
    norms = torch.where(mask[..., None] > 0, norms, torch.full((), -1.0, dtype=norms.dtype,
                                                               device=norms.device))
    padded_n = F.pad(norms, (0, 0) + (pad, pad) * 3, value=-1.0)
    padded_f = F.pad(feats, (0, 0, 0, 0) + (pad, pad) * 3)
    end = d + 2 * pad - kernel + 1
    best_n = best_f = None
    for dz in range(kernel):
        for dy in range(kernel):
            for dx in range(kernel):
                sl = (slice(None), slice(dz, dz + end, stride), slice(dy, dy + end, stride),
                      slice(dx, dx + end, stride))
                sl_n, sl_f = padded_n[sl], padded_f[sl]
                if best_n is None:
                    best_n, best_f = sl_n, sl_f
                else:
                    take = sl_n > best_n
                    best_n = torch.where(take, sl_n, best_n)
                    best_f = torch.where(take[..., None], sl_f, best_f)
    new_mask = (best_n.amax(dim=-1) >= 0).to(mask.dtype)
    return best_f * new_mask[..., None, None].to(best_f.dtype), new_mask


# ---------------------------------------------------------------------------
# Segment reductions (pointgroup sec_mean/min/max)
# ---------------------------------------------------------------------------
def _segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """The segment of each of n rows delimited by offsets [S+1]."""
    rows = torch.arange(n, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets[1:].contiguous(), rows, right=True)


def _segment_reduce(feats: torch.Tensor, offsets: torch.Tensor, n_segments: int,
                    reduce: str, fill: float) -> torch.Tensor:
    """scatter_reduce of the rows into n_segments rows that start at
    `fill`; rows past the last segment are dropped, as jax.ops.segment_*
    drop out-of-range ids."""
    n, c = feats.shape[0], feats.shape[-1]
    seg = _segment_ids(offsets, n)
    keep = seg < n_segments
    out = torch.full((n_segments,) + tuple(feats.shape[1:]), fill, dtype=feats.dtype,
                     device=feats.device)
    idx = seg[keep].view(-1, *([1] * (feats.dim() - 1))).expand(-1, *feats.shape[1:])
    return out.scatter_reduce(0, idx, feats[keep], reduce, include_self=True)


def sec_mean(feats: torch.Tensor, offsets: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Segment mean over offset-delimited rows: feats [N, C], offsets
    [S+1] -> [n_segments, C] (0 for an empty segment)."""
    sums = _segment_reduce(feats, offsets, n_segments, "sum", 0.0)
    counts = _segment_reduce(torch.ones_like(feats[:, :1]), offsets, n_segments, "sum", 0.0)
    return sums / torch.clamp(counts, min=1.0)


def sec_min(feats: torch.Tensor, offsets: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Segment minimum (+inf for an empty segment)."""
    return _segment_reduce(feats, offsets, n_segments, "amin", float("inf"))


def sec_max(feats: torch.Tensor, offsets: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Segment maximum (-inf for an empty segment)."""
    return _segment_reduce(feats, offsets, n_segments, "amax", float("-inf"))


# ---------------------------------------------------------------------------
# PointGroup leftovers (reference pointgroup_ops.py:115-253 -- shipped by the
# reference though unused by DCL-Net; provided for surface parity)
# ---------------------------------------------------------------------------
def ballquery_batch_p(
    xyz: np.ndarray, batch_offsets: np.ndarray, radius: float, mean_active: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat-batch ball query (reference ballquery_batch_p,
    pointgroup_ops.py:115-150): for each point, the indices of all points of
    the SAME batch within `radius`, CSR-style (start_len [N,2], idx [total]).

    Host-side numpy (the reference runs it on GPU with a retry-on-capacity
    loop; here the output is exact with no capacity cap).
    """
    n = xyz.shape[0]
    start_len = np.zeros((n, 2), np.int32)
    idx_chunks = []
    total = 0
    for b in range(len(batch_offsets) - 1):
        s, e = int(batch_offsets[b]), int(batch_offsets[b + 1])
        pts = xyz[s:e]
        d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
        within = d2 <= radius * radius
        for i in range(e - s):
            nbrs = np.where(within[i])[0] + s
            start_len[s + i] = (total, len(nbrs))
            idx_chunks.append(nbrs)
            total += len(nbrs)
    idx = np.concatenate(idx_chunks) if idx_chunks else np.zeros(0, np.int32)
    return idx.astype(np.int32), start_len


def bfs_cluster(
    semantic_label: np.ndarray, ball_idx: np.ndarray, start_len: np.ndarray,
    threshold: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Semantic-constrained connected-component clustering over ball-query
    neighborhoods (reference bfs_cluster, pointgroup_ops.py:153-182; CPU
    find_cc/get_clusters, bfs_cluster.cpp:28-86): FIFO breadth-first walk
    that only expands into SAME-LABEL neighbors; clusters smaller than
    `threshold` are dropped. Members are emitted in discovery order and
    clusters in seed order — row-exact vs the reference's compiled code
    (tests/test_golden_bfs.py).

    Returns (cluster_idx [M, 2] rows of (cluster_id, point_id),
    cluster_offsets [n_clusters+1]).
    """
    semantic_label = np.asarray(semantic_label)
    n = start_len.shape[0]
    visited = np.zeros(n, bool)
    clusters = []
    for seed in range(n):
        if visited[seed]:
            continue
        visited[seed] = True
        members = [seed]
        head = 0
        while head < len(members):
            p = members[head]
            head += 1
            s, l = start_len[p]
            lab = semantic_label[p]
            for q in ball_idx[s : s + l]:
                if visited[q] or semantic_label[q] != lab:
                    continue
                visited[q] = True
                members.append(int(q))
        if len(members) >= threshold:
            clusters.append(members)
    rows = []
    offsets = [0]
    for cid, members in enumerate(clusters):
        rows.extend((cid, p) for p in members)
        offsets.append(offsets[-1] + len(members))
    cluster_idx = np.asarray(rows, np.int32).reshape(-1, 2)
    return cluster_idx, np.asarray(offsets, np.int32)


def roipool(feats: torch.Tensor, proposal_offsets: torch.Tensor) -> torch.Tensor:
    """Max-pool features per proposal segment: feats [N, C] ordered by
    proposal, proposal_offsets [P+1] -> [P, C]."""
    return sec_max(feats, proposal_offsets, proposal_offsets.shape[0] - 1)


def get_iou(
    proposal_idx: np.ndarray, proposal_offsets: np.ndarray,
    instance_labels: np.ndarray, instance_pointnum: np.ndarray,
) -> np.ndarray:
    """IoU between proposals and gt instances (reference get_iou,
    pointgroup_ops.py:224-253). proposal_idx [M,2] (pid, point), labels [N]
    (instance id or -100), instance_pointnum [I]. Returns [P, I]."""
    p = proposal_offsets.shape[0] - 1
    n_inst = len(instance_pointnum)
    ious = np.zeros((p, n_inst), np.float32)
    for pid in range(p):
        pts = proposal_idx[proposal_offsets[pid]:proposal_offsets[pid + 1], 1]
        labels = instance_labels[pts]
        size_p = len(pts)
        for inst in range(n_inst):
            inter = int((labels == inst).sum())
            union = size_p + int(instance_pointnum[inst]) - inter
            ious[pid, inst] = inter / union if union > 0 else 0.0
    return ious
