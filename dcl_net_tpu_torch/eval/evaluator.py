"""Stage-1 and stage-2 evaluation loops: the YCB-V ADD-S AUC protocol and
LineMOD's ADD(-S) < 0.1 d.

Counterpart of dcl_net_tpu/eval/evaluator.py::Evaluator and
Stage2Evaluator without the mesh:
batches arrive padded, with `valid` (0 = lost detection) and `pad` (1 =
fill row, never scored) flags; the model and the distances run on the
device, only [B]-sized results come back to the host, and the aggregation
is numpy. A lost detection scores an infinite distance under adds_auc
(YCB-V); under add_0.1d it is skipped (LineMOD) or, with count_lost,
counted in its class's denominator (Occlusion-LineMOD).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from dcl_net_tpu_torch import resolve_device, strict_f32
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.eval.metrics import (
    add_batch, add_s_batch, per_class_auc_acc, success_at_diameter,
)
from dcl_net_tpu_torch.models.refiner import refine_pose

PROTOCOLS = ("adds_auc", "add_0.1d")


class Evaluator:
    """Stage-1 evaluator.

    Args:
      model: the port's DCLNet (weights loaded); moved to `device`, eval mode.
      model_points: [num_classes, P, 3] CAD clouds for the metric.
      protocol: "adds_auc" (YCB-V: every row ADD-S, AUC) or "add_0.1d"
        (LineMOD, Occlusion-LineMOD: ADD, or ADD-S for a symmetric row,
        against 0.1 x diameter).
      sym_class_ids: classes scored by ADD-S under add_0.1d besides the rows
        whose sym_flag is set.
      diameters: per class, 0.1 x the diameter in metres (add_0.1d).
      count_lost: add_0.1d counts lost detections in the denominator.
      template_bank: optional {"feats": [C, M, 7], "voxel_idx": [C, M, 3]}
        per-class template inputs; the template branch is then encoded once
        per class and gathered per instance.
      device: CUDA unless the caller names another.
    """

    def __init__(self, model, model_points: np.ndarray,
                 protocol: str = "adds_auc",
                 template_bank: Optional[Dict[str, np.ndarray]] = None,
                 device=None, logger=None, sym_class_ids: Sequence[int] = (),
                 diameters: Optional[Sequence[float]] = None,
                 count_lost: bool = False):
        if protocol not in PROTOCOLS:
            raise ValueError(f"protocol {protocol!r}: one of {PROTOCOLS}")
        if protocol == "add_0.1d" and diameters is None:
            raise ValueError("protocol add_0.1d needs the diameters")
        strict_f32()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_points = torch.as_tensor(
            np.asarray(model_points, np.float32), device=self.device)
        self.protocol = protocol
        self.sym_class_ids = sorted({int(i) for i in sym_class_ids})
        self.diameters = None if diameters is None else list(diameters)
        self.count_lost = bool(count_lost)
        self.logger = logger
        self._tmp_cache = None
        if template_bank is not None:
            bank = batch_to_torch({"tmp": dict(template_bank)}, self.device)
            with torch.inference_mode():
                self._tmp_cache = self.model.encode_template(bank)

    def _run(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Forward + ADD-S (and ADD under add_0.1d) for one device batch."""
        cls = batch["labels"]["obj_idx"].long()
        with torch.inference_mode():
            if self._tmp_cache is not None:
                obs = self.model.encode_observed(batch)
                tmp = {k: v[cls] for k, v in self._tmp_cache.items()}
                out = self.model.fuse(obs, tmp)
            else:
                out = self.model(batch)
            rot, trans = self._pose(out)
            pose = (self.model_points[cls], rot, trans,
                    batch["labels"]["rot_gt"], batch["labels"]["trans_gt"])
            res = {"adds": add_s_batch(*pose), "rot_pred": rot, "trans_pred": trans,
                   "overflow": out["overflow"]}
            if self.protocol == "add_0.1d":
                res["add"] = add_batch(*pose)
        return res

    def _pose(self, out: Dict[str, torch.Tensor]):
        """The pose that is scored: stage 1's."""
        return out["rot_pred"], out["trans_pred"]

    def evaluate(self, loader: Iterable[Dict[str, Any]]) -> Dict[str, object]:
        """One pass over host batches (make_batch(...).to_dict()); returns
        the protocol's report plus n_overflow, n_scored (the distances
        aggregated) and n_lost (the lost detections among the real rows)."""
        distances: List[float] = []
        class_ids: List[int] = []
        lost_per_class: Dict[int, int] = {}
        n_overflow = 0
        n_lost = 0
        for batch in loader:
            res = self._run(batch_to_torch(batch, self.device))
            adds = res["adds"].cpu().numpy()
            add = res["add"].cpu().numpy() if "add" in res else adds
            ovf = res["overflow"].cpu().numpy()
            valid = np.asarray(batch["valid"])
            pad = np.asarray(batch.get("pad", np.zeros_like(valid)))
            cls = np.asarray(batch["labels"]["obj_idx"], np.int64)
            sym = np.asarray(batch["sym_flag"])
            n_overflow += int((ovf & (valid > 0) & ~(pad > 0)).sum())
            n_lost += int(((valid <= 0) & ~(pad > 0)).sum())
            self._score_batch(adds, add, valid, cls, sym, pad,
                              distances, class_ids, lost_per_class)
        result = self.summarize(distances, class_ids, lost_per_class)
        result["n_overflow"] = n_overflow
        result["n_scored"] = len(distances)
        result["n_lost"] = n_lost
        if n_overflow and self.logger:
            self.logger.warning(
                "capacity overflow: %d scored instances exceeded a voxel-extraction "
                "budget (model.capacities); their highest-index voxels were dropped "
                "and the reported metrics may understate the model" % n_overflow)
        return result

    def _score_batch(self, adds, add, valid, cls, sym, pad,
                     distances, class_ids, lost_per_class) -> None:
        """Pad rows are skipped. A lost row (valid = 0) scores inf under
        adds_auc; under add_0.1d it is skipped, or counted per class with
        count_lost. Every other row scores its ADD-S distance under
        adds_auc; under add_0.1d its ADD-S if it is symmetric (sym_flag > 0
        or a class of sym_class_ids), else its ADD."""
        real = ~(pad > 0)
        lost = real & (valid <= 0)
        if lost.any():
            if self.count_lost:
                for c, n in zip(*np.unique(cls[lost], return_counts=True)):
                    lost_per_class[int(c)] = lost_per_class.get(int(c), 0) + int(n)
            elif self.protocol == "adds_auc":
                distances.extend([np.inf] * int(lost.sum()))
                class_ids.extend(cls[lost].tolist())
        scored = real & (valid > 0)
        if scored.any():
            if self.protocol == "adds_auc":
                dist = adds
            else:
                use_adds = (sym > 0) | np.isin(cls, np.asarray(self.sym_class_ids, np.int64))
                dist = np.where(use_adds, adds, add)
            distances.extend(float(x) for x in dist[scored])
            class_ids.extend(cls[scored].tolist())

    def summarize(self, distances, class_ids, lost_per_class=None) -> Dict[str, object]:
        """The protocol's report: per-class AUC and <2 cm accuracy
        (adds_auc), or per-class success rates and counts (add_0.1d)."""
        if self.protocol == "adds_auc":
            return per_class_auc_acc(
                distances, class_ids, num_classes=int(self.model_points.shape[0]),
                logger=self.logger)
        lost = None
        if self.count_lost:
            lost = [(lost_per_class or {}).get(i, 0) for i in range(len(self.diameters))]
        return success_at_diameter(distances, class_ids, self.diameters,
                                   num_lost_per_class=lost, logger=self.logger)


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
