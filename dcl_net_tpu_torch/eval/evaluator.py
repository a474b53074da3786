"""Stage-1 and stage-2 evaluation loops (YCB-V ADD-S AUC protocol).

Counterpart of dcl_net_tpu/eval/evaluator.py::Evaluator and
Stage2Evaluator without the mesh:
batches arrive padded, with `valid` (0 = lost detection, scored as an
infinite distance) and `pad` (1 = fill row, never scored) flags; the model
and the ADD-S distances run on the device, only [B]-sized results come back
to the host, and the AUC aggregation is numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from dcl_net_tpu_torch import resolve_device, strict_f32
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.eval.metrics import add_s_batch, per_class_auc_acc
from dcl_net_tpu_torch.models.refiner import refine_pose


class Evaluator:
    """Stage-1 evaluator.

    Args:
      model: the port's DCLNet (weights loaded); moved to `device`, eval mode.
      model_points: [num_classes, P, 3] CAD clouds for the metric.
      protocol: "adds_auc" (YCB-V), the one this slice ports.
      template_bank: optional {"feats": [C, M, 7], "voxel_idx": [C, M, 3]}
        per-class template inputs; the template branch is then encoded once
        per class and gathered per instance.
      device: CUDA unless the caller names another.
    """

    def __init__(self, model, model_points: np.ndarray,
                 protocol: str = "adds_auc",
                 template_bank: Optional[Dict[str, np.ndarray]] = None,
                 device=None, logger=None):
        if protocol != "adds_auc":
            raise ValueError(f"protocol {protocol!r}: the port evaluates adds_auc")
        strict_f32()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_points = torch.as_tensor(
            np.asarray(model_points, np.float32), device=self.device)
        self.protocol = protocol
        self.logger = logger
        self._tmp_cache = None
        if template_bank is not None:
            bank = batch_to_torch({"tmp": dict(template_bank)}, self.device)
            with torch.inference_mode():
                self._tmp_cache = self.model.encode_template(bank)

    def _run(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Forward + ADD-S for one device batch."""
        cls = batch["labels"]["obj_idx"].long()
        with torch.inference_mode():
            if self._tmp_cache is not None:
                obs = self.model.encode_observed(batch)
                tmp = {k: v[cls] for k, v in self._tmp_cache.items()}
                out = self.model.fuse(obs, tmp)
            else:
                out = self.model(batch)
            rot, trans = self._pose(out)
            adds = add_s_batch(
                self.model_points[cls], rot, trans,
                batch["labels"]["rot_gt"], batch["labels"]["trans_gt"])
        return {"adds": adds, "rot_pred": rot, "trans_pred": trans,
                "overflow": out["overflow"]}

    def _pose(self, out: Dict[str, torch.Tensor]):
        """The pose that is scored: stage 1's."""
        return out["rot_pred"], out["trans_pred"]

    def evaluate(self, loader: Iterable[Dict[str, Any]]) -> Dict[str, object]:
        """One pass over host batches (make_batch(...).to_dict()); returns
        the per-class report plus n_overflow, n_scored and n_lost (the lost
        detections among the n_scored rows)."""
        distances: List[float] = []
        class_ids: List[int] = []
        n_overflow = 0
        n_lost = 0
        for batch in loader:
            res = self._run(batch_to_torch(batch, self.device))
            adds = res["adds"].cpu().numpy()
            ovf = res["overflow"].cpu().numpy()
            valid = np.asarray(batch["valid"])
            pad = np.asarray(batch.get("pad", np.zeros_like(valid)))
            cls = np.asarray(batch["labels"]["obj_idx"], np.int64)
            n_overflow += int((ovf & (valid > 0) & ~(pad > 0)).sum())
            n_lost += int(((valid <= 0) & ~(pad > 0)).sum())
            self._score_batch(adds, valid, cls, pad, distances, class_ids)
        result = per_class_auc_acc(
            distances, class_ids, num_classes=int(self.model_points.shape[0]),
            logger=self.logger)
        result["n_overflow"] = n_overflow
        result["n_scored"] = len(distances)
        result["n_lost"] = n_lost
        return result

    @staticmethod
    def _score_batch(adds, valid, cls, pad, distances, class_ids) -> None:
        """Pad rows are skipped; lost rows (valid = 0) score inf; the rest
        score their ADD-S distance."""
        real = ~(pad > 0)
        lost = real & (valid <= 0)
        distances.extend([np.inf] * int(lost.sum()))
        class_ids.extend(cls[lost].tolist())
        scored = real & (valid > 0)
        distances.extend(float(x) for x in adds[scored])
        class_ids.extend(cls[scored].tolist())


class Stage2Evaluator(Evaluator):
    """Stage-1 + iterative refiner eval (dcl_net_tpu/eval/evaluator.py::
    Stage2Evaluator): the stage-1 encode (template cache as in Evaluator)
    and fuse, then `iterations` refine/compose steps (models/refiner.py::
    refine_pose), then ADD-S of the refined pose. Takes Evaluator's
    arguments besides the refiner."""

    def __init__(self, model, refiner, model_points: np.ndarray,
                 iterations: int = 2, **kw):
        super().__init__(model, model_points, **kw)
        self.refiner = refiner.to(self.device).eval()
        self.iterations = int(iterations)

    def _pose(self, out: Dict[str, torch.Tensor]):
        return refine_pose(self.refiner, out["points_inp"], out["F_Xo_p"], out["conf"],
                           out["rot_pred"], out["trans_pred"], self.iterations)
