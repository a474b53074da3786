"""K3: masked 3-NN interpolation, and K4, its backward: hand-written CUDA
kernels (csrc/interp.cu, csrc/inverse_index.cuh).

Replace the Pallas kernels of dcl_net_tpu/ops/pallas_interp.py (forward and
custom-VJP backward). `nn_interpolate` is the differentiable entry point:
an autograd Function whose forward is K3 and whose backward is K4, with the
gradient w.r.t. the features only, as the JAX custom VJP gives. A CUDA
tensor goes through the kernels, a CPU tensor through the plain versions;
there is no fallback.

K4 and the fused path's backward K7 (ops/cuda_fused.py) share the inverse
index: each sample's 3N contributions e = k * N + t grouped by slot, in
ascending e, so that every output row is the sum of its contributions in
the plain version's order (`inverse_index_reference`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcl_net_tpu_torch.ops import cuda_build
from dcl_net_tpu_torch.ops.knn import BIG, iterated_argmin

# Launches of K3, of K4 and of the inverse index alone (inverse_index_cuda)
# since the last reset (set to 0 to reset).
launches = 0
bwd_launches = 0
index_launches = 0

# K3's block: QUERIES queries, each scanned by SCAN_LANES lanes of a warp
# (csrc/interp.cu; swept by scripts/sweep_interp_compact.py).
SCAN_LANES = 4
QUERIES = 128
LANE_CHOICES = (2, 4, 8)
QUERY_CHOICES = (32, 64, 128)

# The inverse index sorts a sample's 3N entries in one block: N <= MAX_POINTS.
MAX_POINTS = 2048
# The writers of K4 and K7 (csrc/inverse_index.cuh: kWriterThreads): one
# thread a (row, channel), WRITER_THREADS a block, so C <= WRITER_THREADS.
WRITER_THREADS = 256


def writer_rows(c: int) -> int:
    """Rows a K4 or K7 writer block sums at once, and K4's rows per block:
    WRITER_THREADS // c (8 at C = 32, 1 at 256)."""
    return max(1, WRITER_THREADS // c)


def index_scratch_words(b: int, n: int, v: int) -> int:
    """int32 words of the inverse index of b samples of 3n entries over v
    slots: start [b, v + 1], then ent [b, 3n]."""
    return b * (v + 1 + 3 * n)


def nn_interpolate_reference(
    points: torch.Tensor, centers: torch.Tensor, feats: torch.Tensor,
    mask: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel. n_valid is taken and ignored: under its
    precondition (mask 0 from n_valid[b] on) it changes nothing.

    Squared distances by direct differences, summed over axes 0, 1, 2 in
    that order; masked centers at BIG; iterated-argmin top 3 (ties to the
    lowest index); w = recip * (1 / sum(recip)) with recip = 1/(d^2 + 1e-8).
    Returns out [B, N, C], w [B, 3, N] and idx [B, 3, N] int32."""
    diff = points[:, :, None, :] - centers[:, None, :, :]  # [B, N, V, 3]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    d2 = torch.where(mask[:, None, :] > 0, d2, torch.full_like(d2, BIG))
    dist, idx = iterated_argmin(d2, 3)
    recip = 1.0 / (dist + 1e-8)
    w = recip * (1.0 / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]))
    batch = torch.arange(points.shape[0], device=points.device)[:, None, None]
    terms = feats[batch, idx.long()] * w[..., None]  # [B, N, 3, C]
    out = (terms[:, :, 0] + terms[:, :, 1]) + terms[:, :, 2]
    return out, w.transpose(1, 2).contiguous(), idx.transpose(1, 2).contiguous()


def check_n_valid(name: str, n_valid: Optional[torch.Tensor], b: int, device) -> None:
    """n_valid, where given, is int32 [b], contiguous, on `device`; raise
    ValueError otherwise."""
    if n_valid is None:
        return
    req = cuda_build.require
    req(n_valid.dtype == torch.int32 and tuple(n_valid.shape) == (b,), name,
        lambda: f"n_valid must be int32 [{b}], got {n_valid.dtype} {tuple(n_valid.shape)}")
    req(n_valid.device == device, name, "inputs on different devices")
    req(n_valid.is_contiguous(), name, "n_valid must be contiguous")


def nn_interpolate_cuda(
    points: torch.Tensor, centers: torch.Tensor, feats: torch.Tensor,
    mask: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3-NN inverse-squared-distance interpolation of [B, V, C] features at
    [B, V, 3] centers (valid where mask [B, V] > 0) onto [B, N, 3] points.

    All inputs f32 and contiguous. n_valid [B] int32, optional: the kernel
    reads and scans only rows [0, min(n_valid[b], V)) of sample b, so the
    mask must be 0 from there on (K2's occupancy meets that for K2's
    output; it may exceed V, which is the capacity). Without it all V rows
    are scanned. The result is the same either way. Returns out [B, N, C]
    and, for the backward, the weights w [B, 3, N] and indices idx
    [B, 3, N] int32."""
    global launches
    name = "nn_interpolate_cuda"
    check_n_valid(name, n_valid, points.shape[0], points.device)
    if points.device.type == "cpu":
        return nn_interpolate_reference(points, centers, feats, mask)
    req = cuda_build.require
    req(points.is_cuda, name, lambda: f"unsupported device {points.device}")
    req(points.dim() == 3 and points.shape[-1] == 3, name,
        lambda: f"points must be [B, N, 3], got {tuple(points.shape)}")
    b, n, _ = points.shape
    req(feats.dim() == 3 and feats.shape[0] == b, name,
        lambda: f"feats must be [{b}, V, C], got {tuple(feats.shape)}")
    v, c = feats.shape[1], feats.shape[2]
    req(v > 0, name, "no centers")
    req(tuple(centers.shape) == (b, v, 3), name, lambda: f"centers must be [{b}, {v}, 3]")
    req(tuple(mask.shape) == (b, v), name, lambda: f"mask must be [{b}, {v}]")
    req(b <= 65535, name, lambda: f"batch {b} above 65535 (the kernel's grid y)")
    for t in (points, centers, feats, mask):
        req(t.dtype == torch.float32, name, lambda: f"inputs must be f32, got {t.dtype}")
        req(t.device == points.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    lanes, queries = SCAN_LANES, QUERIES
    req(lanes in LANE_CHOICES and queries in QUERY_CHOICES, name,
        lambda: f"SCAN_LANES {lanes} / QUERIES {queries} not in {LANE_CHOICES} / "
        f"{QUERY_CHOICES}")
    dev = points.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    w = torch.empty((b, 3, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, 3, n), dtype=torch.int32, device=dev)
    cuda_build.launch(
        "dclx_interp", name, dev,
        points.data_ptr(), centers.data_ptr(), feats.data_ptr(), mask.data_ptr(),
        None if n_valid is None else n_valid.data_ptr(),
        out.data_ptr(), w.data_ptr(), idx.data_ptr(), b, n, v, c, lanes, queries)
    launches += 1
    return out, w, idx


def nn_interpolate_bwd_reference(g: torch.Tensor, w: torch.Tensor,
                                 idx: torch.Tensor, v: int) -> torch.Tensor:
    """Plain version of K4: dfeats[b, idx[b,k,t], :] += w[b,k,t] * g[b,t,:].

    g [B, N, C]; w, idx [B, 3, N] as K3 writes them. Returns [B, V, C]. On
    the CPU, index_add_ adds each row's terms w * g (each rounded once) one
    by one in ascending e = k * N + t from 0, the order K4 sums in."""
    b, n, c = g.shape
    terms = w[..., None] * g[:, None, :, :]                     # [B, 3, N, C]
    rows = (idx.long() + v * torch.arange(b, device=g.device)[:, None, None])
    out = torch.zeros((b * v, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows.reshape(-1), terms.reshape(-1, c))
    return out.reshape(b, v, c)


def inverse_index_reference(idx: torch.Tensor, v: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the inverse index of K4 and K7: for each sample of
    idx [B, 3, N], its entries e = k * N + t sorted stably by slot idx[e].
    Returns start [B, V + 1] (slot s holds the positions [start[s],
    start[s + 1])) and ent [B, 3N], both int32. An idx outside [0, V) sorts
    past start[V]."""
    b = idx.shape[0]
    slot = idx.reshape(b, -1).long()
    slot = torch.where((slot >= 0) & (slot < v), slot, torch.full_like(slot, v))
    keys, ent = torch.sort(slot, dim=1, stable=True)
    bounds = torch.arange(v + 1, device=idx.device).expand(b, -1).contiguous()
    start = torch.searchsorted(keys, bounds)
    return start.to(torch.int32), ent.to(torch.int32)


def check_bwd_inputs(name: str, g: torch.Tensor, w: torch.Tensor,
                     idx: torch.Tensor) -> Tuple[int, int, int]:
    """Check the inputs that K4 and K7 share (the cotangent g [B, N, C] f32
    and K3's or K6's w [B, 3, N] f32, idx [B, 3, N] int32, contiguous, on
    one CUDA device); raise ValueError otherwise. Returns (B, N, C)."""
    req = cuda_build.require
    req(g.is_cuda, name, lambda: f"unsupported device {g.device}")
    req(g.dtype == torch.float32 and g.dim() == 3, name,
        lambda: f"g must be f32 [B, N, C], got {g.dtype} {tuple(g.shape)}")
    b, n, c = g.shape
    req(w.dtype == torch.float32 and tuple(w.shape) == (b, 3, n), name,
        lambda: f"w must be f32 [{b}, 3, {n}]")
    req(idx.dtype == torch.int32 and tuple(idx.shape) == (b, 3, n), name,
        lambda: f"idx must be int32 [{b}, 3, {n}]")
    req(n <= MAX_POINTS, name,
        lambda: f"{n} points per sample: the inverse index takes at most {MAX_POINTS}")
    req(c <= WRITER_THREADS, name,
        lambda: f"{c} channels: the writer takes at most {WRITER_THREADS}")
    req(b <= 65535, name, lambda: f"batch {b} above 65535 (the kernel's grid y)")
    for t in (g, w, idx):
        req(t.device == g.device, name, "inputs on different devices")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    return b, n, c


def inverse_index_cuda(idx: torch.Tensor, v: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse index alone (the first of K4's and K7's two kernels), to
    hold it to `inverse_index_reference`: start [B, V + 1] and ent [B, 3N]
    int32 from idx [B, 3, N] int32 (each in [0, V))."""
    global index_launches
    if idx.device.type == "cpu":
        return inverse_index_reference(idx, v)
    name = "inverse_index_cuda"
    req = cuda_build.require
    req(idx.is_cuda, name, lambda: f"unsupported device {idx.device}")
    req(idx.dtype == torch.int32 and idx.dim() == 3 and idx.shape[1] == 3, name,
        lambda: f"idx must be int32 [B, 3, N], got {idx.dtype} {tuple(idx.shape)}")
    req(idx.is_contiguous(), name, "idx must be contiguous")
    b, _, n = idx.shape
    req(n <= MAX_POINTS, name,
        lambda: f"{n} points per sample: the inverse index takes at most {MAX_POINTS}")
    req(v > 0, name, "no slots")
    scratch = torch.empty(index_scratch_words(b, n, v), dtype=torch.int32, device=idx.device)
    cuda_build.launch("dclx_inverse_index", name, idx.device,
                      idx.data_ptr(), scratch.data_ptr(), b, n, v)
    index_launches += 1
    split = b * (v + 1)
    return scratch[:split].view(b, v + 1), scratch[split:].view(b, 3 * n)


def nn_interpolate_bwd_cuda(g: torch.Tensor, w: torch.Tensor,
                            idx: torch.Tensor, v: int) -> torch.Tensor:
    """K4: the features' gradient of the 3-NN interpolation, [B, V, C] f32,
    from the output cotangent g [B, N, C] and K3's w, idx [B, 3, N].

    One kernel entry point: the inverse index into an int32 scratch, then
    blocks of `writer_rows(C)` rows sum each (row, channel)'s contributions
    in the plain version's order and write every row once (allocated
    empty). Bit-equal to the plain version on the CPU, and deterministic."""
    global bwd_launches
    if g.device.type == "cpu":
        return nn_interpolate_bwd_reference(g, w, idx, v)
    name = "nn_interpolate_bwd_cuda"
    b, n, c = check_bwd_inputs(name, g, w, idx)
    cuda_build.require(v > 0, name, "no centers")
    dfeats = torch.empty((b, v, c), dtype=torch.float32, device=g.device)
    scratch = torch.empty(index_scratch_words(b, n, v), dtype=torch.int32, device=g.device)
    cuda_build.launch(
        "dclx_interp_bwd", name, g.device,
        g.data_ptr(), w.data_ptr(), idx.data_ptr(), dfeats.data_ptr(), scratch.data_ptr(),
        b, n, v, c, writer_rows(c))
    bwd_launches += 1
    return dfeats


class NNInterpolate(torch.autograd.Function):
    """K3 forward, K4 backward. Points, centers and mask get no gradient
    (None), as in dcl_net_tpu/ops/pallas_interp.py::_vjp_bwd: the points are
    data and the centers come from integer voxel coordinates."""

    @staticmethod
    def forward(ctx, points, centers, feats, mask, n_valid):
        out, w, idx = nn_interpolate_cuda(points, centers, feats, mask, n_valid)
        ctx.save_for_backward(w, idx)
        ctx.n_centers = feats.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        w, idx = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[2]:
            dfeats = nn_interpolate_bwd_cuda(g.contiguous(), w, idx, ctx.n_centers)
        return None, None, dfeats, None, None


def nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                   feats: torch.Tensor, mask: torch.Tensor,
                   n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable 3-NN interpolation [B, N, C] (see nn_interpolate_cuda;
    n_valid bounds the rows the kernel scans)."""
    return NNInterpolate.apply(points, centers, feats, mask, n_valid)
