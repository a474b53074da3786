"""DCL-Net stage-1 network and its losses (PyTorch).

Counterpart of dcl_net_tpu/models/dcl_net.py, split the same way:
  encode_observed / encode_template: voxelize (kernel K1) -> backbone ->
    multi-scale 3-NN interpolation (kernels K2 and K3, or K2 and the fused
    K6 with interp_mode="pallas_fused", or a window of cells on the dense
    grids with interp_mode="local") -> the four disengage heads of that
    branch;
  fuse: bidirectional attention + confidence + pose heads + SVD pose.
forward = fuse(encode_observed(batch), encode_template(batch)). The template
branch depends only on the class's CAD cloud, so the evaluator encodes it
once per class (eval/evaluator.py), and forward_with_template_bank does the
same in training. The module's mode is JAX's `train` flag: .train() uses
batch statistics and updates the BN running statistics in place, .eval()
(the state after construction) folds them.

Batch contract (channel-last, fixed shapes, as the JAX package's):
  {"inp": {"feats": [B,N,7] f32, "voxel_idx": [B,N,3] int32},
   "tmp": {"feats": [B,M,7] f32, "voxel_idx": [B,M,3] int32}, ...}
with features [1, rgb, xyz].

Parameter names follow the JAX tree (backbone_inp.conv0, disengage_Xc_p1.
Dense_0, ...) so weights.py maps one to the other by layout alone.

dtype (model.compute_dtype) is the feature compute type, as the JAX
model's `dtype`: None runs f32; torch.bfloat16 runs the grids, the backbone,
the point features, the heads, the attention and the neck in bf16 (K1, K2,
K3 and K6 through their bf16 variants), with the parameters kept in f32
and cast at use. Voxel counts and masks, points, distances, the SVD and the
pose stay f32: rot_pred is f32, trans_pred, conf and F_Xo_p are bf16, as in
the JAX model. A bf16 model trains too: the gradients flow back through the
bf16 variants of the backward kernels (K4 and K5, or K7), the BN statistics
and running statistics stay f32, and the parameters and their gradients
stay f32 (bf16 is the compute type only).

remat (model.remat) recomputes each backbone's activations in the backward
instead of keeping them (torch.utils.checkpoint around SparseBackbone, as
the JAX model wraps it in nn.remat): the dense-grid conv activations are
most of a training step's memory. The recomputation leaves the BN running
statistics alone, so a step updates them once, as without remat, and runs
under the data-parallel context of its forward (parallel/mesh.py), so it
reissues the same BN collectives on every rank in the same order.

Data parallelism (parallel/mesh.py): under sharded(group) the batch is this
rank's block of a global batch, the train-mode BatchNorms take the global
batch's statistics and dcl_losses weighs each row by the global count of
valid rows. The template bank of forward_with_template_bank is encoded
whole on every rank and takes no collective.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dcl_net_tpu_torch import resolve_device
from dcl_net_tpu_torch.geometry.rotation import ortho9d_to_matrix
from dcl_net_tpu_torch.geometry.transform import (
    chamfer_distance,
    l2_distance,
    transform_points,
    untransform_points,
)
from dcl_net_tpu_torch.models.backbone import MultiScalePointFeatures, SparseBackbone
from dcl_net_tpu_torch.models.blocks import (
    MaskedBatchNorm, PointMLP, init_weights, sigmoid, softmax,
)
from dcl_net_tpu_torch.ops.knn import knn
from dcl_net_tpu_torch.ops.cuda_voxelize import voxelize_cuda
from dcl_net_tpu_torch.ops.voxelize import (
    MODE_MEAN, MODE_SUM, MODE_UNIQUE, MODES, voxelize_dense,
)
from dcl_net_tpu_torch.parallel.mesh import (
    all_reduce_sum, batch_group, replicated, sharded,
)
from dcl_net_tpu_torch.registry import MODELS

_POINT_FEATS = 480  # 32 + 64 + 128 + 256


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _disengager(out_dim: int, dtype) -> PointMLP:
    # two 1x1 conv blocks 480 -> 256 -> out, BN before act, no bias
    return PointMLP(_POINT_FEATS, (256, out_dim), ("relu", "relu"),
                    (True, True), bn_before_act=True, use_bias=False, dtype=dtype)


def _head(in_dim: int, dims, acts, bns, dtype) -> PointMLP:
    # Conv1d stacks with bias, BN after act
    return PointMLP(in_dim, dims, acts, bns, bn_before_act=False, use_bias=True,
                    dtype=dtype)


def aligner(ri_1: torch.Tensor, ri_2: torch.Tensor, re_2: torch.Tensor):
    """Cross-attention aligner.

    ri_1 [B, N1, C], ri_2 [B, N2, C], re_2 [B, N2, E] ->
    (re_embed [B, N1, E], attention [B, N2, N1], softmax over N2)."""
    att = softmax(ri_2 @ ri_1.transpose(1, 2), dim=1)
    return att.transpose(1, 2) @ re_2, att


@MODELS.register("DCL_Net")
class DCLNet(nn.Module):
    """The stage-1 DCL-Net.

    voxelization_mode: 0 (unique), 1 (first), 2 (last), 3 (sum) or 4 (mean,
    DCL-Net's), as the JAX model takes them (ops/voxelize.py). Modes 3 and
    4 run K1, in the bf16 variant under a bf16 model; mode 0 runs K1's
    sum and modes 1 and 2 stock PyTorch, each on f32 features, the grid
    then cast to the compute type, as the JAX model voxelizes them.
    interp_mode: the point-feature path of both branches
    (models/backbone.py::MultiScalePointFeatures).
    device: where the module lives, CUDA unless the caller names another.
    seed: the weights are drawn from a torch.Generator with this seed
    (lecun-normal kernels, zero biases, identity BN statistics), on the CPU
    and then moved, so the same seed gives the same weights everywhere.
    dtype: the feature compute type, None (f32) or torch.bfloat16 (the
    module docstring says what runs in which type); another raises.
    remat: recompute the backbones' activations in the backward of a
    train-mode forward (the module docstring)."""

    def __init__(
        self,
        voxelization_mode: int = MODE_MEAN,
        unit_voxel_extent: Sequence[float] = (0.006, 0.006, 0.006),
        voxel_num_limit: Sequence[int] = (64, 64, 64),
        kernel_size: int = 3,
        capacities: Sequence[int] = (2048, 1024, 512, 64),
        interp_mode: str = "exact",
        device=None,
        seed: int = 0,
        dtype=None,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = bool(remat)
        if dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"dtype {dtype}: None (f32) or torch.bfloat16")
        self.dtype = dtype
        if voxelization_mode not in MODES:
            raise ValueError(f"voxelization mode {voxelization_mode}: one of {MODES}")
        self.voxelization_mode = int(voxelization_mode)
        self.grid_shape = tuple(int(d) for d in voxel_num_limit)
        self.backbone_inp = SparseBackbone(kernel_size=kernel_size, dtype=dtype)
        self.backbone_tmp = SparseBackbone(kernel_size=kernel_size, dtype=dtype)
        pf_kw = dict(unit_voxel_extent=tuple(unit_voxel_extent),
                     voxel_num_limit=self.grid_shape, capacities=tuple(capacities),
                     interp_mode=interp_mode)
        self.point_feats_inp = MultiScalePointFeatures(**pf_kw)
        self.point_feats_tmp = MultiScalePointFeatures(**pf_kw)

        for side in ("Xc", "Yo"):
            for name, dim in (("p1", 256), ("m1", 64), ("p2", 256), ("m2", 64)):
                self.add_module(f"disengage_{side}_{name}", _disengager(dim, dtype))
        no_bn = (False,) * 3
        last_none = ("relu", "relu", "none")
        self.regressor_Xo = _head(256, (256, 128, 3), last_none, no_bn, dtype)
        self.regressor_Yc = _head(256, (256, 128, 3), last_none, no_bn, dtype)
        self.regressor_conf = _head(128, (128, 128, 1), last_none, no_bn, dtype)
        self.regressor_conf_bi = _head(128, (128, 128, 1), last_none, no_bn, dtype)
        self.neck_fuser = _head(512, (512, 512, 1024), ("relu",) * 3, (True,) * 3, dtype)
        self.neck_fuser_bi = _head(512, (512, 512, 1024), ("relu",) * 3, (True,) * 3,
                                   dtype)
        self.regressor_rot = _head(1024, (512, 128, 9), last_none, no_bn, dtype)
        self.regressor_trans = _head(1024, (512, 128, 3), last_none, no_bn, dtype)

        self.reset_parameters(seed)
        self.to(resolve_device(device))
        self.eval()

    @classmethod
    def from_config(cls, model_cfg: Mapping[str, Any], **kw) -> "DCLNet":
        """Build from a config's `model` block (configs/config_YCBV_bs32.yaml)."""
        args = dict(
            voxelization_mode=int(model_cfg.get("voxelization_mode", MODE_MEAN)),
            unit_voxel_extent=tuple(model_cfg["unit_voxel_extent"]),
            voxel_num_limit=tuple(model_cfg["voxel_num_limit"]),
            kernel_size=int(model_cfg.get("backbone", {}).get("kernel_size", 3)),
            interp_mode=str(model_cfg.get("interp_mode", "exact")),
            dtype=compute_dtype(model_cfg),
            remat=bool(model_cfg.get("remat", False)),
        )
        if "capacities" in model_cfg:
            args["capacities"] = tuple(model_cfg["capacities"])
        args.update(kw)
        return cls(**args)

    def reset_parameters(self, seed: int = 0) -> None:
        init_weights(self, seed)

    # ------------------------------------------------------------------
    # Branch encoders
    # ------------------------------------------------------------------
    def _encode(self, backbone, point_feats, feats, voxel_idx):
        mode = self.voxelization_mode
        if mode in (MODE_SUM, MODE_MEAN):
            grid, count = voxelize_cuda(feats, voxel_idx, self.grid_shape, mode=mode,
                                        out_dtype=self.dtype)
        else:
            # modes 0-2: an f32 grid in the compute type, as the JAX model's
            # voxelize_dense feeds its convolutions; mode 0 is K1's sum,
            # modes 1 and 2 a selection no kernel computes
            if mode == MODE_UNIQUE:
                grid, count = voxelize_cuda(feats, voxel_idx, self.grid_shape, mode=MODE_SUM)
            else:
                grid, count = voxelize_dense(feats, voxel_idx, self.grid_shape, mode)
            grid = grid.to(self.dtype or grid.dtype)
        mask = (count > 0).to(feats.dtype)
        if self.remat and self.training and torch.is_grad_enabled():
            group = batch_group()
            pyramid = checkpoint(
                backbone, grid, mask, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    _recompute_context(backbone, group)))
        else:
            pyramid = backbone(grid, mask)
        points = feats[..., 4:7].contiguous()
        interp, overflow = point_feats(points, pyramid)
        return points, interp, overflow

    def _heads(self, side: str, points, f, overflow) -> Dict[str, torch.Tensor]:
        out = {"points": points, "overflow": overflow}
        for name in ("p1", "m1", "p2", "m2"):
            out[name] = getattr(self, f"disengage_{side}_{name}")(f)
        return out

    def encode_observed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Observed branch: backbone + interp + the four Xc disengage heads."""
        points, f, overflow = self._encode(
            self.backbone_inp, self.point_feats_inp,
            batch["inp"]["feats"], batch["inp"]["voxel_idx"])
        return self._heads("Xc", points, f, overflow)

    def encode_template(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Template branch: backbone + interp + the four Yo disengage heads.
        Depends only on the CAD cloud, so eval caches it per class."""
        points, f, overflow = self._encode(
            self.backbone_tmp, self.point_feats_tmp,
            batch["tmp"]["feats"], batch["tmp"]["voxel_idx"])
        return self._heads("Yo", points, f, overflow)

    # ------------------------------------------------------------------
    # Fusion: attention + confidence + pose heads
    # ------------------------------------------------------------------
    def fuse(self, obs: Dict[str, torch.Tensor], tmp: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        f_xo_p, att = aligner(obs["m1"], tmp["m1"], tmp["p1"])     # [B, N, 256]
        xo_pred = self.regressor_Xo(f_xo_p)
        f_yc_p, att_bi = aligner(tmp["m2"], obs["m2"], obs["p2"])  # [B, M, 256]
        yc_pred = self.regressor_Yc(f_yc_p)

        f_xo_m = att.transpose(1, 2) @ tmp["m1"]                   # [B, N, 64]
        f_m1 = torch.cat([obs["m1"], f_xo_m], dim=-1)              # [B, N, 128]
        f_yc_m = att_bi.transpose(1, 2) @ obs["m2"]                # [B, M, 64]
        f_m2 = torch.cat([f_yc_m, tmp["m2"]], dim=-1)              # [B, M, 128]
        conf = sigmoid(torch.cat(
            [self.regressor_conf(f_m1), self.regressor_conf_bi(f_m2)], dim=1))
        conf_softmax = softmax(conf, dim=1)

        f_p1 = self.neck_fuser(torch.cat([obs["p1"], f_xo_p], dim=-1))
        f_p2 = self.neck_fuser_bi(torch.cat([f_yc_p, tmp["p2"]], dim=-1))
        f_p = torch.cat([f_p1, f_p2], dim=1)                       # [B, N+M, 1024]
        f_p_wei = torch.sum(f_p * conf_softmax, dim=1)             # [B, 1024]

        ortho9d = self.regressor_rot(f_p_wei[:, None, :])[:, 0, :]
        rot_pred = ortho9d_to_matrix(ortho9d[:, :3], ortho9d[:, 3:6],
                                     ortho9d[:, 6:])
        trans_pred = self.regressor_trans(f_p_wei[:, None, :])[:, 0, :]
        return {
            "trans_pred": trans_pred,                    # [B, 3]
            "rot_pred": rot_pred,                        # [B, 3, 3]
            "conf": conf[..., 0],                        # [B, N+M]
            "overflow": obs["overflow"] | tmp["overflow"],  # [B] bool
            "F_Xo_p": f_xo_p,                            # [B, N, 256]
            "Xo_pred": xo_pred,                          # [B, N, 3]
            "Yc_pred": yc_pred,                          # [B, M, 3]
            "points_inp": obs["points"],                 # [B, N, 3]
            "points_tmp": tmp["points"],                 # [B, M, 3]
        }

    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.fuse(self.encode_observed(batch), self.encode_template(batch))

    def forward_with_template_bank(self, batch: Dict[str, Any],
                                   bank: Dict[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
        """Forward that encodes the per-class template bank
        {"feats": [C, M, 7], "voxel_idx": [C, M, 3]} once and gathers it
        per instance by labels.obj_idx. Equal to forward when the batch's
        classes are distinct; with repeated classes the template branch's
        BN statistics weight each class once instead of each instance.
        Under data parallelism every rank encodes the whole bank, as one
        process does: replicated, without collectives."""
        obs = self.encode_observed(batch)
        with replicated():
            tmp_all = self.encode_template({"tmp": bank})
        cls = batch["labels"]["obj_idx"].long()
        return self.fuse(obs, {k: v[cls] for k, v in tmp_all.items()})


@contextlib.contextmanager
def _recompute_context(backbone: nn.Module, group):
    """The context of a checkpointed backbone's recomputation in the
    backward: its BN running statistics frozen (_frozen_statistics), and
    the data-parallel group of its forward (parallel/mesh.py::sharded),
    whose collectives the recomputation reissues."""
    with sharded(group), _frozen_statistics(backbone):
        yield


@contextlib.contextmanager
def _frozen_statistics(backbone: nn.Module):
    """The context of a checkpointed backbone's recomputation: its
    MaskedBatchNorms normalise with the batch statistics as in the forward
    but leave their running statistics as the forward left them (flax's
    nn.remat keeps the forward's batch_stats)."""
    norms = [m for m in backbone.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m in norms:
            m.update_running = True


def compute_dtype(model_cfg: Mapping[str, Any]):
    """The feature compute type of a config's `model` block: compute_dtype
    "float32" (or absent) -> None, "bfloat16" -> torch.bfloat16."""
    name = model_cfg.get("compute_dtype")
    name = "float32" if name is None else str(name)
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"model.compute_dtype {name!r}: one of {tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def dcl_losses(pred: Dict[str, torch.Tensor], batch: Dict[str, Any]
               ) -> Dict[str, torch.Tensor]:
    """Stage-1 losses (dcl_net_tpu/models/dcl_net.py::dcl_losses).

    Rows with valid = 0 weigh nothing and the denominator counts the valid
    rows, so shapes stay fixed. Each jax.lax.stop_gradient of the JAX
    function is a .detach() here.

    Under data parallelism (parallel/mesh.py::sharded) the batch is this
    rank's block and the denominator counts the valid rows of the global
    batch, as JAX's sum over the sharded batch does: each rank's losses are
    its share of the global losses, the global loss is the all-reduced SUM
    of the ranks' losses, and the global gradient the all-reduced SUM of
    their gradients (train/solver.py::apply_gradients).

    A bf16 model's trans_pred, conf, Xo_pred and Yc_pred are bf16 (rot_pred
    and the points f32). Each term takes the type JAX's promotion gives it:
    a bf16 value meeting an f32 one is widened, so every per-point loss is
    f32, while the confidence's log term stays bf16, its constant 0.01
    rounded to bf16 first, as JAX does with a Python scalar."""
    rot_pred = pred["rot_pred"]
    trans_pred = pred["trans_pred"]
    sym = batch["sym_flag"][:, None]                            # [B, 1]
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones(rot_pred.shape[0], dtype=rot_pred.dtype,
                           device=rot_pred.device)
    w = valid / torch.clamp(all_reduce_sum(valid.sum(), batch_group()), min=1.0)  # [B]

    rot_gt = batch["labels"]["rot_gt"]
    trans_gt = batch["labels"]["trans_gt"]
    points_tmp = pred["points_tmp"]
    points_inp = pred["points_inp"]
    conf = pred["conf"]                                         # [B, N+M]

    tmp_posed_pred = transform_points(points_tmp, rot_pred, trans_pred)
    tmp_posed_gt = transform_points(points_tmp, rot_gt, trans_gt)
    pose_per_point = ((1 - sym) * l2_distance(tmp_posed_pred, tmp_posed_gt)
                      + sym * chamfer_distance(tmp_posed_pred, tmp_posed_gt))
    loss_pose = torch.sum(w * pose_per_point.mean(dim=1))

    xo_pred = pred["Xo_pred"]
    yc_pred = pred["Yc_pred"]
    inp_cano_pred = untransform_points(points_inp, rot_pred, trans_pred).detach()
    inp_cano_gt = untransform_points(points_inp, rot_gt, trans_gt).detach()
    loss_xo_pp = (1 - sym) * l2_distance(xo_pred, inp_cano_gt) + 0.5 * sym * (
        chamfer_distance(xo_pred, points_tmp) + l2_distance(xo_pred, inp_cano_pred))
    loss_xo = torch.sum(w * loss_xo_pp.mean(dim=1))

    loss_yc_pp = (1 - sym) * l2_distance(yc_pred, tmp_posed_gt) + 0.5 * sym * (
        chamfer_distance(yc_pred, tmp_posed_gt)
        + l2_distance(yc_pred, tmp_posed_pred.detach()))
    loss_yc = torch.sum(w * loss_yc_pp.mean(dim=1))

    # confidence self-calibration against the detached per-point losses
    pp = torch.cat([loss_xo_pp, loss_yc_pp], dim=1).detach()    # [B, N+M]
    # JAX takes the weak scalar in conf's type: bf16(0.01) under bf16
    log_weight = float(torch.tensor(0.01, dtype=conf.dtype))
    conf_term = pp * conf - log_weight * torch.log(torch.clamp(conf, min=1e-12))
    loss_conf = torch.sum(w * conf_term.mean(dim=1))

    loss_all = loss_pose + 5.0 * loss_xo + 1.0 * loss_yc + 1.0 * loss_conf
    return {
        "loss_pose": loss_pose,
        "loss_Xo": loss_xo,
        "loss_Yc": loss_yc,
        "loss_conf": loss_conf,
        "loss_all": loss_all,
    }


def get_cano_label(points_tmp: torch.Tensor, points_inp: torch.Tensor,
                   rot_pred: torch.Tensor, trans_gt: torch.Tensor) -> torch.Tensor:
    """Nearest template point [B, N, 3] to each observed point taken back to
    the canonical frame by (rot_pred, trans_gt)."""
    inp_cano = untransform_points(points_inp, rot_pred, trans_gt)
    _, idx = knn(1, inp_cano, points_tmp)
    return torch.gather(points_tmp, 1, idx[..., 0:1].long().expand(-1, -1, 3))
