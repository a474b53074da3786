"""Sparse-3D-conv semantics on dense masked grids (plain PyTorch).

Counterpart of dcl_net_tpu/ops/sparse_conv.py: a submanifold conv is a dense
conv over masked features re-masked by the input mask, a regular stride-1
sparse conv dilates the mask by the kernel footprint, the sparse average
pool divides a window sum by the window's occupied count, and batch-norm
statistics run over occupied voxels only. Besides DCL-Net's path: the
sparse max pool (with the reference's tie-exact gradient), the sparse
transposed conv and the sparse inverse conv, which DCL-Net never runs.
Grids are channel-last [B, D0, D1, D2, C]; masks are [B, D0, D1, D2].

The same conv and pool also run on the active sites alone (ActiveSet,
window_table, conv_rows, avg_pool_rows): each site set is a list
of rows in raster order (b, d0, d1, d2), a k^3 neighbour table of row ids
per conv or pool, and a gather and a few GEMMs per conv (the eval-mode
backbone, models/backbone.py).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcl_net_tpu_torch.parallel.mesh import active, all_reduce_sum


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """[B, D0, D1, D2, C] -> [B, C, D0, D1, D2] as a view (channels_last_3d)."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


WINDOW_SUM_CHUNK = 1 << 30  # elements of one padded buffer of window_sum


def window_sum_rows(c: int, spatial, padding: int) -> int:
    """The samples of a [B, D0, D1, D2, c] grid whose zero-padded buffer holds
    at most WINDOW_SUM_CHUNK elements: window_sum sums a larger batch in
    chunks of that many."""
    d0, d1, d2 = (int(d) + 2 * padding for d in spatial)
    return max(1, WINDOW_SUM_CHUNK // (c * d0 * d1 * d2))


def window_sum(x: torch.Tensor, kernel: int, stride: int, padding: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k^3 box sum with zero padding of a channel-last grid [B, D0, D1, D2, C],
    of x * mask[..., None] where a mask [B, D0, D1, D2] is given.

    The zero padding is explicit because avg_pool3d refuses inputs smaller
    than the kernel (the 2^3 level of a 16^3 grid) even when padded. x (and
    the mask) are written straight into the interior of one zero-filled
    contiguous [B, C, ...] buffer, which avg_pool3d reads without a copy:
    one grid-sized temporary instead of three (the product, the pad and
    avg_pool3d's contiguous copy), which had been the largest of eval's
    temporaries at the configs' batch of 512 (PERF.md, section 6).

    A bf16 grid is summed as the JAX package sums it (dcl_net_tpu/ops/
    sparse_conv.py::_conv_window_sum): three separable k-tap passes, axis 0,
    then 1, then 2, each one a bf16 convolution whose sums XLA takes in f32
    and rounds to bf16, so the result is rounded three times. On the card
    each pass is avg_pool3d on the bf16 buffer, which sums in f32 and
    rounds its output to bf16; torch has no BFloat16 avg_pool3d on the CPU,
    so there each pass sums in f32 and is rounded to bf16 after it. Autograd
    differentiates the three passes, each backward pass rounded to bf16,
    which is where XLA rounds the transposes of its three bf16 convolutions
    (bit-equal to the JAX pool's gradient on the CPU).

    The batch is summed in chunks whose padded buffer holds at most
    WINDOW_SUM_CHUNK elements: a 64^3 level of 32 channels at batch 256
    holds 2^31 (the padded buffer more), past the 32-bit element indices
    that avg_pool3d's CUDA kernels take; the sums are per sample, so the
    chunks change no value."""
    b, d0, d1, d2, c = x.shape
    p = padding
    rows = window_sum_rows(c, (d0, d1, d2), p)
    if b > rows:
        return torch.cat([window_sum(x[i:i + rows], kernel, stride, padding,
                                     None if mask is None else mask[i:i + rows])
                          for i in range(0, b, rows)])
    xp = x.new_zeros((b, c, d0 + 2 * p, d1 + 2 * p, d2 + 2 * p))
    inner = xp[:, :, p:p + d0, p:p + d1, p:p + d2]
    inner.copy_(_ncdhw(x))
    if mask is not None:
        inner.mul_(mask[:, None])
    if x.dtype != torch.bfloat16:
        return _ndhwc(F.avg_pool3d(xp, kernel, stride, divisor_override=1))
    for axis in range(3):
        k, st = [1, 1, 1], [1, 1, 1]
        k[axis], st[axis] = kernel, stride
        if xp.is_cuda:
            xp = F.avg_pool3d(xp, k, st, divisor_override=1)
        else:
            xp = F.avg_pool3d(xp.float(), k, st, divisor_override=1).to(torch.bfloat16)
    return _ndhwc(xp)


def dilate_mask(mask: torch.Tensor, kernel: int = 3, stride: int = 1,
                padding: Optional[int] = None) -> torch.Tensor:
    """Kernel-footprint dilation of an occupancy mask (stride 1, pad k//2 by
    default): the active output set of a regular sparse conv."""
    if padding is None:
        padding = kernel // 2
    m = (mask > 0).to(torch.float32)[:, None]
    if padding > kernel // 2:  # past max_pool3d's padding limit: pad first
        m = F.pad(m, (padding,) * 6)
        padding = 0
    d = F.max_pool3d(m, kernel, stride, padding)[:, 0]
    return d.to(mask.dtype)


def sparse_avg_pool(feats: torch.Tensor, mask: torch.Tensor, kernel: int = 3,
                    stride: int = 2, padding: Optional[int] = None, use_gs: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """True-average sparse pooling (padding k//2 by default): the window
    sum of occupied features over the window's occupied count (DCL-Net's),
    or with use_gs over the whole window's volume k^3. Returns the pooled
    features [B, D', D', D', C] (zero where empty) and mask."""
    pad = kernel // 2 if padding is None else padding
    m = mask.to(feats.dtype)
    s = window_sum(feats, kernel, stride, pad, mask=m)
    cnt = window_sum(m[..., None], kernel, stride, pad)[..., 0]
    new_mask = (cnt > 0).to(mask.dtype)
    out = s / float(kernel ** 3) if use_gs else s / torch.clamp(cnt, min=1.0)[..., None]
    return out * new_mask[..., None].to(feats.dtype), new_mask


GATHER_BYTES = 1 << 30  # bytes of one gathered block of conv_rows / avg_pool_rows
GEMM_K = 64  # the most terms of one GEMM's sums in conv_rows


class ActiveSet:
    """The active sites of one grid, numbered in raster order (b, d0, d1,
    d2), the order torch.nonzero gives.

    occ is the occupancy padded with `pad` cells of False on each side of
    each spatial axis, [B, P0, P1, P2] bool, so that a k^3 window (pad =
    k // 2) of any site reads inside it. The constructor queues the
    occupancy's running count (no host wait), count() is its total as a
    one-element tensor, and index(n), with that total read on the host,
    lists the sites. A site's row id is its running count less one, so
    ids() reads the rows of any cells from the occupancy and the running
    count alone, without a grid of ids."""

    def __init__(self, occ: torch.Tensor, pad: int):
        self.occ = occ
        self.pad = int(pad)
        self.padded = tuple(int(d) for d in occ.shape)
        b, *dims = self.padded
        self.shape = (b, *(d - 2 * self.pad for d in dims))
        self._running = torch.cumsum(occ.reshape(-1), 0, dtype=torch.int32)
        self.n: Optional[int] = None

    @classmethod
    def of_mask(cls, mask: torch.Tensor, pad: int) -> "ActiveSet":
        """The sites where mask [B, D0, D1, D2] > 0."""
        return cls(F.pad(mask > 0, (pad,) * 6), pad)

    def window_any(self, kernel: int, stride: int) -> "ActiveSet":
        """The cells whose k^3 window (this stride, padding self.pad) holds a
        site: at stride 1 dilate_mask's set (a regular conv's output), at
        stride 2 sparse_avg_pool's. Three separable passes of ORs of
        strided views of the padded occupancy, one an axis (on a bool grid:
        max_pool3d and avg_pool3d take floats, and max_pool3d writes int64
        indices besides)."""
        x = self.occ
        for axis, d in enumerate(self.shape[1:], start=1):
            length = (d + 2 * self.pad - kernel) // stride + 1
            taps = []
            for a in range(kernel):
                cut = [slice(None)] * 4
                cut[axis] = slice(a, a + (length - 1) * stride + 1, stride)
                taps.append(x[tuple(cut)])
            x = functools.reduce(torch.bitwise_or, taps)
        return ActiveSet(F.pad(x, (self.pad,) * 6), self.pad)

    def mask(self, dtype: torch.dtype) -> torch.Tensor:
        """The unpadded occupancy [B, D0, D1, D2] as 0 / 1 of `dtype`."""
        p = self.pad
        _, d0, d1, d2 = self.shape
        return self.occ[:, p:p + d0, p:p + d1, p:p + d2].to(dtype)

    def count(self) -> torch.Tensor:
        """The number of sites, [1] int32 on the device."""
        return self._running[-1:]

    def index(self, n: int) -> None:
        """List the sites, given their number as count() read it."""
        self.n = int(n)
        want = torch.arange(1, self.n + 1, dtype=torch.int32, device=self.occ.device)
        self.sites = torch.searchsorted(self._running, want)

    def ids(self, cells: torch.Tensor) -> torch.Tensor:
        """The row ids of cells of the flat padded grid, -1 where inactive
        (the padding included), int32 of cells' shape."""
        return torch.where(self.occ.reshape(-1)[cells], self._running[cells] - 1, -1)

    def coords(self) -> List[torch.Tensor]:
        """(b, d0, d1, d2) of each site, unpadded, as four [n] int64."""
        _, p0, p1, p2 = self.padded
        s = self.sites
        out = [s % p2 - self.pad]
        s = s // p2
        out.append(s % p1 - self.pad)
        s = s // p1
        out.append(s % p0 - self.pad)
        out.append(s // p0)
        return out[::-1]

    def linear(self) -> torch.Tensor:
        """Each site's index in the unpadded grid flattened, [n] int64."""
        b, z, y, x = self.coords()
        _, d0, d1, d2 = self.shape
        return ((b * d0 + z) * d1 + y) * d2 + x


def window_table(out: ActiveSet, inp: ActiveSet, kernel: int, stride: int) -> torch.Tensor:
    """The neighbour table of a conv or pool of kernel k, `stride` and
    padding inp.pad (k // 2) from the sites of `inp` to those of `out`: for
    each output site q and tap (a, b, c) in F.conv3d's order (d0, then d1,
    then d2), the row of `inp` at q * stride - pad + (a, b, c), or -1 where
    that cell is inactive or outside the grid. A stride-1 conv's `out` lies
    on inp's grid; a pool's on the grid it pools to. [n_out, k^3] int32."""
    b, z, y, x = out.coords()
    _, p0, p1, p2 = inp.padded
    corner = ((b * p0 + stride * z) * p1 + stride * y) * p2 + stride * x
    a = torch.arange(kernel, device=corner.device)
    taps = ((a[:, None, None] * p1 + a[None, :, None]) * p2 + a[None, None, :]).reshape(-1)
    return inp.ids(corner[:, None] + taps)


def site_rows(grid: torch.Tensor, sites: ActiveSet) -> torch.Tensor:
    """The rows of a dense grid [B, D0, D1, D2, C] at the sites, with one
    zero row after them: [n + 1, C]."""
    c = grid.shape[-1]
    rows = grid.new_zeros((sites.n + 1, c))
    torch.index_select(grid.reshape(-1, c), 0, sites.linear(), out=rows[:sites.n])
    return rows


def scatter_rows(rows: torch.Tensor, sites: ActiveSet) -> torch.Tensor:
    """The dense grid [B, D0, D1, D2, C] that holds rows[:n] at the sites
    and exact zeros elsewhere."""
    c = rows.shape[-1]
    grid = rows.new_zeros((*sites.shape, c))
    grid.view(-1, c).index_copy_(0, sites.linear(), rows[:sites.n])
    return grid


def _gather_rows(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """rows[table], -1 reading the zero row that ends rows: [*table.shape,
    C]. Indexed by row and channel together, so that the gather runs a
    thread an element: rows[table] alone (as index_select and a gather
    over an expanded index) gives each row a thread block of its own,
    whose count, not the bytes, sets the time on rows of 16 to 64
    channels."""
    channels = torch.arange(rows.shape[1], device=rows.device)
    return rows[table.unsqueeze(-1), channels]


def _chunks(n: int, row_bytes: int):
    """Row ranges of [0, n) whose gathered block stays within GATHER_BYTES."""
    step = max(1, GATHER_BYTES // max(row_bytes, 1))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def conv_rows(rows: torch.Tensor, table: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """relu(conv + bias) on the active sites, output-stationary: each output
    row gathers its k^3 neighbour rows (-1 reads the zero row that ends
    `rows`) into [n_out, k^3 * C_in] and multiplies it by `weight`
    [k^3 * C_in, C_out] (F.conv3d's kernel [C_out, C_in, k, k, k] permuted
    to (k, k, k, C_in, C_out)); then the bias add and the ReLU on the rows.
    No scatter: every output row is written once.

    The product sums in at least f32 (a bf16 block and weight are widened,
    so their products are exact) and is cast to the rows' type once, then
    the bias add and the ReLU run in that type, as F.conv3d's bf16 path
    does. It runs as GEMMs of at most GEMM_K terms, a few taps each,
    added in tap order: a BLAS splits a longer sum in an order that
    follows the number of rows and of threads (MKL does), and a sample's
    rows must not depend on the batch around them, as the dense path's
    per-sample conv does not. The gathered block is split by rows to stay
    within GATHER_BYTES.

    rows [n_in + 1, C_in] (the last row zero), table [n_out, k^3] int32;
    returns [n_out + 1, C_out], its last row zero."""
    n_out, taps = table.shape
    c_in, c_out = rows.shape[1], weight.shape[1]
    wide = torch.promote_types(rows.dtype, torch.float32)
    per = max(1, GEMM_K // c_in)  # taps a GEMM
    weight = weight.to(wide)
    out = rows.new_empty((n_out + 1, c_out))
    out[n_out].zero_()
    for s, e in _chunks(n_out, taps * c_in * weight.element_size()):
        block = _gather_rows(rows, table[s:e]).view(e - s, taps * c_in).to(wide)
        acc = out[s:e] if out.dtype == wide else block.new_empty((e - s, c_out))
        for t in range(0, taps, per):
            a, b = t * c_in, min(taps, t + per) * c_in
            if t == 0:
                torch.mm(block[:, a:b], weight[a:b], out=acc)
            else:
                acc.addmm_(block[:, a:b], weight[a:b])
        if acc.dtype != out.dtype:
            out[s:e] = acc
    out[:n_out].add_(bias).relu_()
    return out


def avg_pool_rows(rows: torch.Tensor, table: torch.Tensor, kernel: int) -> torch.Tensor:
    """sparse_avg_pool on the active sites: each output row is the sum of
    its window's rows (-1 reads the zero row) over the count of active rows
    in the window. The window is summed as window_sum sums it, three
    k-tap passes (d0, then d1, then d2), each in at least f32 and cast
    back to the rows' type: in bf16 rounded after each pass, as the JAX
    package's bf16 pool is.

    rows [n_in + 1, C] (the last row zero), table [n_out, k^3] int32;
    returns [n_out + 1, C], its last row zero."""
    n_out, taps = table.shape
    c = rows.shape[1]
    out = rows.new_empty((n_out + 1, c))
    out[n_out].zero_()
    wide = torch.promote_types(rows.dtype, torch.float32)
    count = (table >= 0).sum(dim=1).to(rows.dtype)
    for s, e in _chunks(n_out, taps * c * rows.element_size()):
        x = _gather_rows(rows, table[s:e]).view(e - s, kernel, kernel, kernel, c)
        for _ in range(3):
            x = x.to(wide).sum(dim=1).to(rows.dtype)
        torch.div(x, count[s:e, None], out=out[s:e])
    return out


def masked_moments(feats: torch.Tensor, mask: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over occupied voxels only, and
    the count of occupied voxels (a 0-d tensor in feats' type).
    feats [B, ..., C]; mask [B, ...].

    Over a batch sharded across `group` (parallel/mesh.py) the statistics
    are the global batch's, in the same two-pass form: the masked sum and
    the count are all-reduced and give the mean, then the masked sum of
    squared deviations from that mean is all-reduced and gives the
    variance. Without a group no collective is taken."""
    m = mask.to(feats.dtype)[..., None]
    axes = tuple(range(feats.dim() - 1))
    count = m.sum()
    total = (feats * m).sum(dim=axes)
    if active(group):
        sums = all_reduce_sum(torch.cat([total, count[None]]), group)
        total, count = sums[:-1], sums[-1]
    denom = torch.clamp(count, min=1.0)
    mean = total / denom
    sq = all_reduce_sum((m * (feats - mean) ** 2).sum(dim=axes), group)
    return mean, sq / denom, count


def masked_batch_norm_stats(feats: torch.Tensor, mask: torch.Tensor, group=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over occupied voxels only
    (masked_moments without the count). feats [B, ..., C]; mask [B, ...]."""
    mean, var, _ = masked_moments(feats, mask, group)
    return mean, var


def dense_to_sparse(feats: torch.Tensor, mask: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first `capacity` occupied voxels (mask > 0) of each sample, in
    linear-index order, as coords [B, V, 3] int32, vfeats [B, V, C] and
    vmask [B, V]; padding rows are zero. Occupied voxels past the capacity
    are dropped.

    A stable sort of the vacancy flags puts occupied cells first in index
    order, as the top_k of dcl_net_tpu/ops/sparse_conv.dense_to_sparse does
    for a 0/1 mask."""
    b = feats.shape[0]
    d0, d1, d2 = feats.shape[1:4]
    c = feats.shape[-1]
    g = d0 * d1 * d2
    occ = mask.reshape(b, g) > 0
    lin = torch.argsort((~occ).to(torch.uint8), dim=1, stable=True)[:, :capacity]
    # vmask in the features' type; under bf16 features it stays f32, as the
    # JAX package's (K2's bf16 variant copies rows only)
    vmask_dtype = torch.float32 if feats.dtype == torch.bfloat16 else feats.dtype
    vmask = torch.gather(occ, 1, lin).to(vmask_dtype)
    vfeats = torch.gather(feats.reshape(b, g, c), 1,
                          lin[..., None].expand(-1, -1, c)) * vmask[..., None].to(feats.dtype)
    i0 = lin // (d1 * d2)
    rem = lin % (d1 * d2)
    coords = torch.stack([i0, rem // d2, rem % d2], dim=-1).to(torch.int32)
    coords = coords * vmask[..., None].to(torch.int32)
    return coords, vfeats, vmask


def _max_pool_forward(feats, mask, kernel, stride, padding, zero_init):
    m = mask > 0
    neg = torch.full((), float("-inf"), dtype=feats.dtype, device=feats.device)
    guarded = _ncdhw(torch.where(m[..., None], feats, neg))
    guarded = F.pad(guarded, (padding,) * 6, value=float("-inf"))
    pooled = _ndhwc(F.max_pool3d(guarded, kernel, stride))
    if zero_init:
        pooled = torch.clamp(pooled, min=0.0)
    cnt = window_sum(m.to(feats.dtype)[..., None], kernel, stride, padding)[..., 0]
    new_mask = (cnt > 0).to(mask.dtype)
    out = torch.where(new_mask[..., None] > 0, pooled, torch.zeros((), dtype=feats.dtype,
                                                                    device=feats.device))
    return out, new_mask


def _tap_views(x: torch.Tensor, kernel: int, stride: int, padding: int, d_out):
    """For each tap (a, b, c) of a k^3 window, the view of x (padded by
    `padding` low and enough high, with zeros) at the input positions
    p = q * stride - padding + tap of the output positions q: a list of
    ((a, b, c), view [B, *d_out, C]) over the padded buffer, which is
    returned too, so that writes into the views land in it."""
    b, *dims, c = x.shape
    hi = [max(0, (o - 1) * stride + kernel - padding - d) for o, d in zip(d_out, dims)]
    xp = x.new_zeros((b, *(d + padding + h for d, h in zip(dims, hi)), c))
    xp[:, padding:padding + dims[0], padding:padding + dims[1],
       padding:padding + dims[2]] = x
    views = []
    for a in range(kernel):
        for bb in range(kernel):
            for cc in range(kernel):
                views.append(((a, bb, cc), xp[:, a:a + (d_out[0] - 1) * stride + 1:stride,
                                              bb:bb + (d_out[1] - 1) * stride + 1:stride,
                                              cc:cc + (d_out[2] - 1) * stride + 1:stride]))
    return xp, views


class _SparseMaxPool(torch.autograd.Function):
    """The sparse max pool with the reference's gradient routing: dout
    reaches EVERY occupied input equal to its output, ties included (each
    of k tied inputs gets the whole dout, not 1/k of it, and not one of
    them alone as max_pool3d's backward would), nothing flows through
    outputs with an empty window, nor through the zero_init clamp (no
    input equals the clamped 0 unless it is 0)."""

    @staticmethod
    def forward(ctx, feats, mask, kernel, stride, padding, zero_init):
        out, new_mask = _max_pool_forward(feats, mask, kernel, stride, padding, zero_init)
        ctx.save_for_backward(feats, mask, out, new_mask)
        ctx.geometry = (kernel, stride, padding)
        ctx.mark_non_differentiable(new_mask)
        return out, new_mask

    @staticmethod
    def backward(ctx, dout, _dmask):
        feats, mask, out, new_mask = ctx.saved_tensors
        kernel, stride, padding = ctx.geometry
        d_out = out.shape[1:4]
        dims = feats.shape[1:4]
        dout = dout * new_mask[..., None].to(dout.dtype)
        _, fviews = _tap_views(feats, kernel, stride, padding, d_out)
        dp, dviews = _tap_views(torch.zeros_like(feats), kernel, stride, padding, d_out)
        for (_, fv), (_, dv) in zip(fviews, dviews):
            dv += torch.where(fv == out, dout, torch.zeros((), dtype=dout.dtype,
                                                          device=dout.device))
        din = dp[:, padding:padding + dims[0], padding:padding + dims[1],
                 padding:padding + dims[2]]
        din = din * (mask > 0)[..., None].to(din.dtype)
        return din, None, None, None, None, None


def sparse_max_pool(feats: torch.Tensor, mask: torch.Tensor, kernel: int = 3,
                    stride: int = 2, padding: Optional[int] = None, zero_init: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse max pool over occupied voxels only: unoccupied inputs never
    win, and an output whose window holds no occupied voxel is 0 and
    unoccupied. zero_init=True (the default) is the reference's: its output
    starts at 0, so a window of negative values only gives 0;
    zero_init=False gives the true maximum. The gradient routes dout into
    every input equal to the output, ties included (_SparseMaxPool).
    Returns (pooled [B, D', D', D', C], new mask [B, D', D', D'])."""
    if padding is None:
        padding = kernel // 2
    return _SparseMaxPool.apply(feats, mask, kernel, stride, padding, zero_init)


def _transposed(x: torch.Tensor, weight: torch.Tensor, stride: int, extent, padding: int
                ) -> torch.Tensor:
    """Sum over active inputs p and taps t of x[p] @ weight[t] into the
    outputs q = p * stride - padding + t, for q in [0, extent) per axis:
    conv_transpose3d without padding (every q >= -padding), then the
    window [padding, padding + extent) of it, zero-filled past its end.
    weight [k, k, k, Cin, Cout]; x [B, D0, D1, D2, Cin]."""
    full = _ndhwc(F.conv_transpose3d(_ncdhw(x), weight.permute(3, 4, 0, 1, 2),
                                     stride=stride))
    lengths = full.shape[1:4]
    need = [max(0, padding + e - n) for e, n in zip(extent, lengths)]
    if any(need):
        full = F.pad(full, (0, 0, 0, need[2], 0, need[1], 0, need[0]))
    return full[:, padding:padding + extent[0], padding:padding + extent[1],
                padding:padding + extent[2]]


def sparse_conv_transpose(feats: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                          stride: int = 2, padding: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse transposed conv (spconv's SparseConvTranspose3d) on a dense
    masked grid: each active input p adds feats[p] @ weight[tap] at every
    output q = p * stride - padding + tap; the active outputs are those any
    active input reaches. weight [k, k, k, Cin, Cout] in the forward convs'
    tap layout. Output extent (D - 1) * stride - 2 * padding + k.
    Returns (out [B, D', D', D', Cout], new mask)."""
    k = weight.shape[0]
    if k - 1 - padding < 0:
        raise NotImplementedError("padding > kernel-1 not supported")
    m = mask.to(feats.dtype)
    extent = [(d - 1) * stride - 2 * padding + k for d in feats.shape[1:4]]
    out = _transposed(feats * m[..., None], weight, stride, extent, padding)
    ones = torch.ones((k, k, k, 1, 1), dtype=feats.dtype, device=feats.device)
    cnt = _transposed(m[..., None], ones, stride, extent, padding)[..., 0]
    new_mask = (cnt > 0).to(mask.dtype)
    return out * new_mask[..., None].to(out.dtype), new_mask


def sparse_inverse_conv(feats: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                        prev_mask: torch.Tensor, stride: int = 2, padding: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse inverse conv (spconv's SparseInverseConv3d): a regular conv's
    pairs replayed with their sides swapped, so the output lies on the
    pre-conv grid of prev_mask [B, D0, D1, D2] (its extent and active set):
    each active input q adds feats[q] @ weight[tap] at p = q * stride -
    padding + tap. Unlike a crop of sparse_conv_transpose, pairs past the
    transpose's own extent are kept where the forward conv's size formula
    floored. Returns (out [B, D0, D1, D2, Cout], prev_mask)."""
    k = weight.shape[0]
    if k - 1 - padding < 0:
        raise NotImplementedError("padding > kernel-1 not supported")
    d_down, d_prev = feats.shape[1:4], prev_mask.shape[1:4]
    for dd, dp in zip(d_down, d_prev):
        if dp + padding - 1 - (dd - 1) * stride < 0:
            raise ValueError(f"prev_mask dim {dp} shorter than the conv geometry "
                             f"allows for input dim {dd}")
    m = mask.to(feats.dtype)
    out = _transposed(feats * m[..., None], weight, stride, list(d_prev), padding)
    return out * prev_mask[..., None].to(out.dtype), prev_mask


def voxel_center_affine(unit_voxel_extent, scale: float, offset
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(unit * scale, offset + 0.5 * unit * scale) as f32 [3] arrays: the
    affine map from voxel coordinates to metric centers at a scale."""
    unit = np.asarray(unit_voxel_extent, dtype=np.float32) * float(scale)
    shift = np.asarray(offset, dtype=np.float32) + 0.5 * unit
    return unit, shift


def voxel_centers(coords: torch.Tensor, unit_voxel_extent, scale: float,
                  offset) -> torch.Tensor:
    """Metric voxel centers at a pyramid scale:
    ``idx * (unit * scale) + offset + 0.5 * (unit * scale)``."""
    unit, shift = voxel_center_affine(unit_voxel_extent, scale, offset)
    unit_t = torch.as_tensor(unit, device=coords.device)
    shift_t = torch.as_tensor(shift, device=coords.device)
    return coords.to(torch.float32) * unit_t + shift_t
