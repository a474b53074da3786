"""Stage-2 iterative pose refiner (PyTorch).

Counterpart of dcl_net_tpu/models/refiner.py:

  input  = concat([(X - t) @ R  (canonicalised observed points, 3 ch),
                   F_Xo_p       (stage-1 embedded features, 256 ch)])  # 259 ch
  conf   = stage-1 confidence [B, N+M]: a softmax over all N+M entries,
           then cut to the first N (not a softmax over N)
  output = delta pose; composition t <- R @ dt + t, R <- R @ dR

The pose is carried in f32 whatever the model's type, and each composition
is a plain f32 bmm (TF32 stays off: dcl_net_tpu_torch.strict_f32), where
the JAX package composes with Precision.HIGHEST. The iteration loop is a
Python loop; training detaches the pose between iterations
(train/stage2.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from dcl_net_tpu_torch import resolve_device
from dcl_net_tpu_torch.geometry.rotation import ortho9d_to_matrix
from dcl_net_tpu_torch.geometry.transform import (
    chamfer_distance,
    l2_distance,
    transform_points,
    untransform_points,
)
from dcl_net_tpu_torch.models.blocks import PointMLP, init_weights, softmax
from dcl_net_tpu_torch.parallel.mesh import all_reduce_sum, batch_group
from dcl_net_tpu_torch.registry import MODELS

_IN_FEATS = 259  # 3 canonical coordinates + the 256 channels of F_Xo_p


@MODELS.register("Refiner")
class Refiner(nn.Module):
    """One refinement step: per-point MLP, confidence pooling, delta pose.

    Children MLP_share (259 -> 512 -> 512 -> 1024), regressor_rot2 (-> 512
    -> 128 -> 9) and regressor_trans2 (-> 512 -> 128 -> 3) are named as in
    the JAX parameter tree, with Dense_i inside, so weights.py maps them.
    device and seed as for DCLNet."""

    def __init__(self, n_inp: int = 1024, device=None, seed: int = 0):
        super().__init__()
        self.n_inp = int(n_inp)
        no_bn = (False,) * 3
        last_none = ("relu", "relu", "none")
        self.MLP_share = PointMLP(_IN_FEATS, (512, 512, 1024), ("relu",) * 3, no_bn)
        self.regressor_rot2 = PointMLP(1024, (512, 128, 9), last_none, no_bn)
        self.regressor_trans2 = PointMLP(1024, (512, 128, 3), last_none, no_bn)
        self.reset_parameters(seed)
        self.to(resolve_device(device))
        self.eval()

    def reset_parameters(self, seed: int = 0) -> None:
        init_weights(self, seed)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{"input_features": [B, N, 259], "conf": [B, N+M]} ->
        {"rot_pred": [B, 3, 3], "trans_pred": [B, 3]}, the delta pose."""
        conf_softmax = softmax(inputs["conf"], dim=1)[:, :self.n_inp]
        shared = self.MLP_share(inputs["input_features"])          # [B, N, 1024]
        pooled = torch.sum(shared * conf_softmax[..., None], dim=1)[:, None, :]
        ortho9d = self.regressor_rot2(pooled)[:, 0, :]
        delta_t = self.regressor_trans2(pooled)[:, 0, :]
        delta_r = ortho9d_to_matrix(ortho9d[:, :3], ortho9d[:, 3:6], ortho9d[:, 6:])
        return {"rot_pred": delta_r, "trans_pred": delta_t}


def refiner_losses(pred: Dict[str, torch.Tensor], trans_cur: torch.Tensor,
                   rot_cur: torch.Tensor, points_tmp: torch.Tensor,
                   sym_flag: torch.Tensor, rot_gt: torch.Tensor,
                   trans_gt: torch.Tensor, valid: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Point-matching loss of one refinement step
    (dcl_net_tpu/models/refiner.py::refiner_losses): the CAD cloud posed by
    the delta, then by the current pose, against the gt-posed cloud, L2 or
    chamfer by the symmetry flag. Rows with valid = 0 weigh nothing.
    Under data parallelism (parallel/mesh.py::sharded) the weights divide
    by the global batch's count of valid rows, so each rank's loss is its
    share of the global loss (their SUM), as in dcl_losses."""
    sym = sym_flag[:, None]
    if valid is None:
        valid = torch.ones(rot_cur.shape[0], dtype=rot_cur.dtype, device=rot_cur.device)
    w = valid / torch.clamp(all_reduce_sum(valid.sum(), batch_group()), min=1.0)
    posed_delta = transform_points(points_tmp, pred["rot_pred"], pred["trans_pred"])
    posed_gt = transform_points(points_tmp, rot_gt, trans_gt)
    posed_refined = transform_points(posed_delta, rot_cur, trans_cur)
    per_point = ((1 - sym) * l2_distance(posed_refined, posed_gt)
                 + sym * chamfer_distance(posed_refined, posed_gt))
    loss_pose = torch.sum(w * per_point.mean(dim=1))
    return {"loss_pose": loss_pose, "loss_all": loss_pose}


def refiner_inputs(points_inp: torch.Tensor, f_xo_p: torch.Tensor,
                   conf: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The refiner's inputs at the current pose: the observed points taken
    back to the canonical frame, next to the stage-1 features."""
    inp_cano = untransform_points(points_inp, rot.to(points_inp.dtype),
                                  trans.to(points_inp.dtype))
    return {"input_features": torch.cat([inp_cano, f_xo_p], dim=-1), "conf": conf}


def compose_pose(rot: torch.Tensor, trans: torch.Tensor,
                 delta: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R @ dR, R @ dt + t) in f32 bmm."""
    rot_new = torch.bmm(rot, delta["rot_pred"].float())
    trans_new = torch.bmm(rot, delta["trans_pred"].float()[..., None])[..., 0] + trans
    return rot_new, trans_new


def refine_pose(refiner: Refiner, points_inp: torch.Tensor, f_xo_p: torch.Tensor,
                conf: torch.Tensor, rot_init: torch.Tensor, trans_init: torch.Tensor,
                iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inference loop: canonicalise -> refiner -> compose, `iterations`
    times, from the stage-1 pose. Returns the f32 (rot [B, 3, 3],
    trans [B, 3])."""
    rot, trans = rot_init.float(), trans_init.float()
    for _ in range(int(iterations)):
        delta = refiner(refiner_inputs(points_inp, f_xo_p, conf, rot, trans))
        rot, trans = compose_pose(rot, trans, delta)
    return rot, trans
