"""Stage-2 (refiner) training step.

Counterpart of dcl_net_tpu/train/stage2.py: the frozen stage-1 model runs
in eval mode under torch.no_grad() (folded BN, so its running statistics
never move, and no graph), its outputs build the refiner's inputs, then
`iterations` refine-and-compose steps each add a point-matching loss. The
pose is detached between iterations, as the JAX step's stop_gradient and
the reference's .detach() do, so the summed loss has the reference's
accumulated gradient. The optimizer is the Solver's (AutoClip, Adam, the
schedule) over the refiner's parameters, with the non-finite skip on the
device (solver.apply_gradients).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from dcl_net_tpu_torch import strict_f32
from dcl_net_tpu_torch.models.refiner import compose_pose, refiner_inputs, refiner_losses
from dcl_net_tpu_torch.train.solver import Optimizer, TrainState, apply_gradients


def make_stage2_train_step(main_model: torch.nn.Module, refiner: torch.nn.Module,
                           opt: Optimizer, iterations: int,
                           model_points: torch.Tensor) -> Callable:
    """The refiner's train step. model_points: [num_classes, P, 3] CAD clouds
    on the device, picked per instance by labels.obj_idx.

    train_step(state, batch) updates the refiner's parameters and
    state.opt_state in place and returns 0-d device tensors: loss_all (the
    sum over iterations), loss_last_iter, grad_norm, overflow_frac (of the
    stage-1 forward) and skipped_nonfinite. Turns TF32 off (strict_f32)."""
    strict_f32()
    params = [p for p in refiner.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
        main_model.eval()
        with torch.no_grad():
            out = main_model(batch)
        labels = batch["labels"]
        cld = model_points[labels["obj_idx"].long()]
        rot, trans = out["rot_pred"].float(), out["trans_pred"].float()
        refiner.train()
        per_iter = []
        for _ in range(int(iterations)):
            pred = refiner(refiner_inputs(out["points_inp"], out["F_Xo_p"], out["conf"],
                                          rot, trans))
            per_iter.append(refiner_losses(
                pred, trans, rot, cld, batch["sym_flag"], labels["rot_gt"],
                labels["trans_gt"], batch.get("valid"))["loss_all"])
            with torch.no_grad():  # compose, detached for the next iteration
                rot, trans = compose_pose(rot, trans, pred)
        loss = torch.stack(per_iter).sum()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        metrics = {"loss_all": loss.detach(), "loss_last_iter": per_iter[-1].detach(),
                   "overflow_frac": out["overflow"].to(torch.float32).mean()}
        metrics["grad_norm"], metrics["skipped_nonfinite"] = apply_gradients(
            params, grads, opt, state, loss)
        return metrics

    return train_step
