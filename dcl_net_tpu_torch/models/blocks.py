"""Building blocks: masked sparse-conv blocks and per-point MLPs (PyTorch).

Counterpart of dcl_net_tpu/models/blocks.py. Grids stay channel-last
[B, D0, D1, D2, C] and point features [B, N, C]; only F.conv3d sees a
[B, C, D0, D1, D2] view (channels_last_3d in memory, so no copy).

In eval mode the blocks normalise with their running statistics, and the
sparse-conv block folds them into its kernel. In train mode (module.train())
they normalise with batch statistics that the gradient flows through and
update the running statistics in place, as the JAX blocks do under
train=True with mutable batch_stats: the sparse-conv block over occupied
voxels (MaskedBatchNorm), the per-point MLPs as flax's nn.BatchNorm.

`dtype` is the compute type of the convolutions and dense layers, as the
JAX blocks' `dtype` (flax's): None computes in the input's type (f32 on
the main path); torch.bfloat16 casts inputs and parameters to bf16 at use,
the parameters staying f32 in the module (so their gradients are f32). In
both modes the BN statistics, the running statistics and the normalisation
run in f32 and the normalised output is cast to the compute type, as the
JAX blocks do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dcl_net_tpu_torch.ops.sparse_conv import conv_rows, dilate_mask, masked_moments
from dcl_net_tpu_torch.parallel.mesh import (
    active, all_reduce_sum, all_reduce_sum_grad, batch_group,
)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """torch.sigmoid; in bf16, 1 / (1 + exp(-x)) with each step rounded to
    bf16, which is how XLA computes jax.nn.sigmoid (lax.logistic) on bf16
    (a third of the outputs differ by an ulp from a sigmoid rounded once)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.softmax; in bf16, jax.nn.softmax's steps with XLA's rounding
    points: exp(x - max) rounded to bf16, their sum taken in f32 (jnp.sum
    upcasts bf16) and rounded to bf16, then the bf16 quotient."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True, dtype=torch.float32).to(torch.bfloat16)


_ACTS = {
    "relu": torch.relu,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "none": lambda x: x,
}


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """BN statistics run in at least f32 (f64 stays f64), as flax's do."""
    return torch.promote_types(x.dtype, torch.float32)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Draw a model's weights from a torch.Generator seeded with `seed`:
    lecun-normal conv and dense kernels, zero biases, identity BN
    parameters and statistics."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=gen) / fan_in ** 0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm1d, MaskedBatchNorm)):
            mod.reset_parameters()


# rows of the leading dim per chunk of _MaskedBatchNormTrain's backward: a
# chunk's f32 temporaries stay near 2^27 elements (512 MB) each
_CHUNK_ELEMENTS = 1 << 27


class _MaskedBatchNormTrain(torch.autograd.Function):
    """Train-mode MaskedBatchNorm: y = (x - mean) / sqrt(var + eps) * weight
    + bias with the masked batch statistics of x (masked_moments) in x's
    statistics type, the values of that expression as autograd would run
    it. Returns (y, mean, var, count); mean, var and the count of occupied
    voxels carry no gradient.

    Autograd of the expression keeps four full-size copies of x in the
    statistics type (f32 under bf16), the most memory of a training step on
    the dense 64^3 grids. This saves x, the mask and the statistics only,
    and the backward recomputes x - mean in chunks of the leading dim. It
    returns x's gradient as autograd does: the normalisation's term and the
    statistics' term each in x's type, then their sum.

    group: the data-parallel group x's batch is sharded over, or None. The
    statistics are then the global batch's (masked_moments), and the
    backward all-reduces its three sums (one collective), so x's gradient
    is the global expression's; the weight's and bias's gradients stay
    this rank's share, which the train step's gradient all-reduce sums."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, eps: float, group=None):
        xs = x.to(_stat_dtype(x))
        mean, var, count = masked_moments(xs, mask, group)
        y = xs - mean
        del xs
        y.div_(torch.sqrt(var + eps)).mul_(weight).add_(bias)
        ctx.save_for_backward(x, mask, mean, var, weight, count)
        ctx.eps = eps
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, count)
        return y, mean, var, count

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gcount):
        x, mask, mean, var, weight, count = ctx.saved_tensors
        sdt = mean.dtype
        r = 1.0 / torch.sqrt(var + ctx.eps)
        w = weight.to(sdt)
        n = torch.clamp(count, min=1.0)
        axes = tuple(range(x.dim() - 1))
        rows = max(1, _CHUNK_ELEMENTS // max(x[0].numel(), 1))
        chunks = list(zip(x.split(rows), mask.split(rows), gy.split(rows)))
        s_g = torch.zeros_like(mean)   # sum of gy
        s_gd = torch.zeros_like(mean)  # sum of gy * (x - mean)
        s_md = torch.zeros_like(mean)  # sum of mask * (x - mean)
        for xc, mc, gc in chunks:
            d = xc.to(sdt) - mean
            s_g += gc.sum(dim=axes)
            s_gd += (gc * d).sum(dim=axes)
            s_md += (d * mc.to(sdt)[..., None]).sum(dim=axes)
        local_g, local_gd = s_g, s_gd  # this rank's shares: the weight's gradients
        if active(ctx.group):
            s_g, s_gd, s_md = all_reduce_sum(torch.cat([s_g, s_gd, s_md]),
                                             ctx.group).chunk(3)
        d_var = -0.5 * w * s_gd * r ** 3
        d_mean = -w * r * s_g + d_var * (-2.0 * s_md / n)
        dx = torch.empty_like(x)
        for (xc, mc, gc), out in zip(chunks, dx.split(rows)):
            m = mc.to(sdt)[..., None]
            norm = (gc * (w * r)).to(x.dtype)
            stats = (m * (d_mean / n + d_var * 2.0 / n * (xc.to(sdt) - mean))).to(x.dtype)
            torch.add(norm, stats, out=out)
        return (dx, None, (local_gd * r).to(weight.dtype), local_g.to(weight.dtype),
                None, None)


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose statistics run over occupied voxels only: biased
    variance to normalise, unbiased for the running update, momentum 0.1
    (flax 0.9), eps 1e-5. Parameters follow nn.BatchNorm1d's names.
    Statistics and output are at least f32: a bf16 input is widened for
    them, and the caller casts the output back. In train mode the
    normalisation runs as _MaskedBatchNormTrain, which keeps only its input
    and the statistics for the backward. update_running = False leaves the
    running statistics alone in train mode (a checkpointed recomputation,
    models/dcl_net.py). Over a batch sharded across ranks
    (parallel/mesh.py::batch_group) the statistics, the count of the
    unbiased variance and so the running update are the global batch's."""

    update_running = True

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return ((x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
                    * self.weight + self.bias)
        y, mean, var, count = _MaskedBatchNormTrain.apply(
            x, mask, self.weight, self.bias, self.eps, batch_group())
        if self.update_running:
            with torch.no_grad():
                m = torch.clamp(count, min=2.0)
                unbiased = var * m / (m - 1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        return y


class SparseConvBlock(nn.Module):
    """Sparse conv (no bias, stride 1, pad k//2) + BN + ReLU on a masked
    dense grid. subm=True keeps the active set; subm=False is a regular
    sparse conv whose active set dilates by the kernel footprint.

    In eval mode the BN running statistics fold into the conv
    (w' = w * s, b' = beta - mean * s, s = gamma / sqrt(var + eps)): one
    conv, then ReLU, then the re-mask that keeps inactive voxels at zero,
    done in place on the conv's output. forward runs it densely over the
    whole grid: training, and the exported serving artifacts
    (models/backbone.py says which forwards take which path);
    forward_rows runs the folded conv on the active sites alone, a gather
    and GEMMs (ops/sparse_conv.py::conv_rows), for the eager eval-mode
    forwards.
    In train mode the conv output is normalised by MaskedBatchNorm over the
    voxels active after the conv (dcl_net_tpu/models/blocks.py:130-145).
    Input invariant: x is zero at inactive voxels.

    With dtype bfloat16 the conv takes bf16 inputs and a bf16 kernel and
    returns bf16 (cuDNN and the CPU accumulate in f32), and the ReLU and the
    re-mask run in bf16, as dcl_net_tpu/models/blocks.py:124-145 does. In
    eval mode the fold runs in f32 before the kernel is cast and b' is added
    in bf16. In train mode the masked statistics, the running update and the
    normalisation run in f32 on the bf16 conv output, whose normalised value
    is cast to bf16."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 subm: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.subm = subm
        self.dtype = dtype
        self.conv = nn.Conv3d(in_features, features, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        k = self.kernel_size
        new_mask = mask if self.subm else dilate_mask(mask, k)
        dt = self.dtype or x.dtype
        if self.training:
            y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.conv.weight.to(dt),
                         padding=k // 2)
            y = self.bn(y.permute(0, 2, 3, 4, 1), new_mask).to(dt)
            return torch.relu(y) * new_mask[..., None].to(y.dtype), new_mask
        w_eff, b_eff = self.folded()
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), w_eff.to(dt),
                     padding=k // 2).permute(0, 2, 3, 4, 1)
        # in place on the conv's fresh output: the values of y + b_eff, relu
        # and the re-mask, in one grid buffer instead of three
        y.add_(b_eff.to(dt)).relu_().mul_(new_mask[..., None].to(y.dtype))
        return y, new_mask

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval-mode kernel and bias with the BN running statistics
        folded in (f32): (w * s, beta - mean * s), s = gamma / sqrt(var +
        eps)."""
        s = self.bn.weight / torch.sqrt(self.bn.running_var + self.bn.eps)
        w_eff = self.conv.weight * s[:, None, None, None, None]
        return w_eff, self.bn.bias - self.bn.running_mean * s

    def forward_rows(self, rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """The eval-mode block on active sites (ops/sparse_conv.py::
        conv_rows): rows [n_in + 1, C_in] with a zero last row, table the
        conv's neighbour table [n_out, k^3]; returns [n_out + 1, C_out].
        The values of forward at the output set's sites, with the same
        compute type and rounding steps; no re-mask, since only active
        sites have rows."""
        w_eff, b_eff = self.folded()
        dt = self.dtype or rows.dtype
        weight = w_eff.permute(2, 3, 4, 1, 0).reshape(-1, w_eff.shape[0])
        return conv_rows(rows.to(dt), table, weight.to(dt), b_eff.to(dt))


class PointMLP(nn.Module):
    """Per-point MLP over [B, N, C]: Linear, then BN and activation in either
    order. bn_before_act=True is the disengage block's ordering
    (BasicBlock_3DCONV); False is the heads' (act, then BN).

    Submodules are named Dense_i and BatchNorm_j, the JAX parameter tree's
    names, so weights map across one to one (weights.py).

    The BN follows flax's nn.BatchNorm, not F.batch_norm: in train mode the
    statistics reduce over every axis but the last, the variance is
    E[x^2] - E[x]^2 clipped at 0 (flax's use_fast_variance), and the
    running variance is updated with that biased variance (momentum 0.1,
    flax's 0.9); then (x - mean) * (rsqrt(var + eps) * scale) + bias. Over
    a batch sharded across ranks (parallel/mesh.py::batch_group) the means
    of x and of x^2 are the global batch's: their sums pass one
    differentiable all-reduce, whose backward all-reduces the cotangent.

    With dtype bfloat16, as flax's Dense and BatchNorm with dtype=bfloat16:
    each dense layer multiplies the bf16 input by the bf16 kernel
    (accumulating in f32, rounding to bf16), then adds the bf16 bias in
    bf16; each BN takes its statistics of the input widened to f32 (train
    mode) and normalises in f32 with the f32 statistics and parameters,
    then returns bf16; the activations run in bf16."""

    def __init__(self, in_dim: int, dims: Sequence[int], acts: Sequence[str],
                 bns: Sequence[bool], bn_before_act: bool = False,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.acts = tuple(acts)
        self.bn_before_act = bn_before_act
        self.bn_index = []
        n_bn = 0
        for i, (dim, bn) in enumerate(zip(dims, bns)):
            self.add_module(f"Dense_{i}", nn.Linear(in_dim, dim, bias=use_bias))
            if bn:
                self.add_module(f"BatchNorm_{n_bn}", nn.BatchNorm1d(dim, eps=1e-5))
                self.bn_index.append(n_bn)
                n_bn += 1
            else:
                self.bn_index.append(None)
            in_dim = dim

    def _bn(self, j: int, x: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, f"BatchNorm_{j}")
        if self.training:
            axes = tuple(range(x.dim() - 1))
            xf = x.to(_stat_dtype(x))
            group = batch_group()
            if group is None:
                mean = xf.mean(dim=axes)
                mean_sq = (xf * xf).mean(dim=axes)
            else:
                sums = all_reduce_sum_grad(
                    torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]), group)
                mean, mean_sq = sums / (xf[..., 0].numel() * group.world)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
                bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        # flax's order of operations: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        y = (x - mean) * mul + bn.bias
        return y if self.dtype is None else y.to(self.dtype)

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        dense = getattr(self, f"Dense_{i}")
        if self.dtype is None:
            return dense(x)
        y = x.to(self.dtype) @ dense.weight.to(self.dtype).t()
        return y if dense.bias is None else y + dense.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (act, j) in enumerate(zip(self.acts, self.bn_index)):
            x = self._dense(i, x)
            if self.bn_before_act:
                if j is not None:
                    x = self._bn(j, x)
                x = _ACTS[act](x)
            else:
                x = _ACTS[act](x)
                if j is not None:
                    x = self._bn(j, x)
        return x
