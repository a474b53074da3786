"""Stage-1 and stage-2 evaluation loops: the YCB-V ADD-S AUC protocol and
LineMOD's ADD(-S) < 0.1 d.

Counterpart of dcl_net_tpu/eval/evaluator.py::Evaluator and
Stage2Evaluator: batches arrive padded, with `valid` (0 = lost detection) and `pad` (1 =
fill row, never scored) flags; the model and the distances run on the
device, only [B]-sized results come back to the host, and the aggregation
is numpy. A lost detection scores an infinite distance under adds_auc
(YCB-V); under add_0.1d it is skipped (LineMOD) or, with count_lost,
counted in its class's denominator (Occlusion-LineMOD).

evaluate pipelines the dispatch one batch deep, as the JAX Evaluator does
(dcl_net_tpu/eval/evaluator.py:212-290): batch i + 1 is copied to the card
from pinned memory without a host wait and its forward dispatched before
batch i's [B]-sized results come back, in one device-to-host copy that was
queued behind batch i's work, and are scored. Every row is scored once, in
loader order.

Data parallelism (group, parallel/mesh.py): each rank scores its block of
every global batch (the loaders' process striding), then the ranks gather
the ragged distances and class ids and sum the per-class lost counts,
n_overflow and n_lost (dcl_net_tpu/eval/evaluator.py:286-316), so every
rank returns the summary of the whole set.
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
from dcl_net_tpu_torch.parallel.mesh import active, all_reduce_sum, allgather_host

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
        per class and gathered per instance (in the model's compute type: a
        bf16 model's cache holds bf16 features). The cache depends on the
        weights: after the model's weights change (load_state_dict, a train
        step between evaluations), update_variables re-encodes it.
      device: CUDA unless the caller names another.
      group: the data-parallel group (parallel/mesh.py), or None: the
        loader yields this rank's blocks and evaluate returns the summary
        of every rank's rows, on every rank.
    """

    def __init__(self, model, model_points: np.ndarray,
                 protocol: str = "adds_auc",
                 template_bank: Optional[Dict[str, np.ndarray]] = None,
                 device=None, logger=None, sym_class_ids: Sequence[int] = (),
                 diameters: Optional[Sequence[float]] = None,
                 count_lost: bool = False, group=None):
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
        self.group = group if active(group) else None
        self.logger = logger
        self._bank_inputs = None
        self._tmp_cache = None
        if template_bank is not None:
            self._bank_inputs = batch_to_torch({"tmp": dict(template_bank)}, self.device)
            self._refresh_template_cache()

    def _refresh_template_cache(self) -> None:
        """Encode the per-class template cache from the model's weights as
        they are now, in eval mode."""
        self.model.eval()
        with torch.inference_mode():
            self._tmp_cache = self.model.encode_template(self._bank_inputs)

    def update_variables(self, state_dict=None) -> "Evaluator":
        """Swap in new weights and re-encode the template cache, which
        depends on them (dcl_net_tpu/eval/evaluator.py::update_variables).
        state_dict: the model's new state (a checkpoint's "model" entry),
        loaded into the evaluated model; None when the model was changed in
        place, as by a train step between evaluations."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        if self._bank_inputs is not None:
            self._refresh_template_cache()
        return self

    def _run(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Forward + ADD-S (and ADD under add_0.1d) for one device batch."""
        cls = batch["labels"]["obj_idx"].long()
        self.model.eval()  # a trainer may share the model and leave it in train mode
        with torch.inference_mode():
            if self._tmp_cache is not None:
                obs = self.model.encode_observed(batch)
                tmp = {k: v[cls] for k, v in self._tmp_cache.items()}
                out = self.model.fuse(obs, tmp)
            else:
                out = self.model(batch)
            # a bf16 model's trans_pred is bf16: the pose is scored in f32
            rot, trans = (t.float() for t in self._pose(out))
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

    # The rows of the block that _dispatch copies back for each batch.
    _ROWS = ("adds", "add", "overflow", "valid", "obj_idx", "sym_flag", "pad")

    def _dispatch(self, batch: Dict[str, Any]):
        """Copy a batch to the device (from pinned memory, without a host
        wait), queue its forward and queue the copy of its [B]-sized results
        and flags (_ROWS) to the host as one f32 block behind it. Returns
        (host block, event recorded after the copy or None), which _fetch
        reads: nothing here waits for the device."""
        tb = batch_to_torch(batch, self.device, non_blocking=True)
        res = self._run(tb)
        zeros = torch.zeros_like(tb["valid"])
        rows = {"adds": res["adds"], "add": res.get("add", res["adds"]),
                "overflow": res["overflow"], "valid": tb["valid"],
                "obj_idx": tb["labels"]["obj_idx"], "sym_flag": tb["sym_flag"],
                "pad": tb.get("pad", zeros)}
        # f32 holds each row exactly: distances are f32, flags 0 / 1, class ids < 2^24
        block = torch.stack([rows[k].reshape(-1).to(torch.float32) for k in self._ROWS])
        if block.device.type != "cuda":
            return block, None
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @classmethod
    def _fetch(cls, pending) -> Dict[str, np.ndarray]:
        """Wait for a _dispatch's copy and split its block into _ROWS."""
        host, done = pending
        if done is not None:
            done.synchronize()
        return dict(zip(cls._ROWS, host.numpy()))

    def evaluate(self, loader: Iterable[Dict[str, Any]]) -> Dict[str, object]:
        """One pass over batches (make_batch(...).to_dict(), or the
        DeviceBatch of device preprocessing); returns
        the protocol's report plus n_overflow, n_scored (the distances
        aggregated) and n_lost (the lost detections among the real rows).
        Batch i + 1 is dispatched before batch i is fetched and scored; the
        last batch is scored after the loop."""
        distances: List[float] = []
        class_ids: List[int] = []
        lost_per_class: Dict[int, int] = {}
        n_overflow = 0
        n_lost = 0

        def consume(pending) -> None:
            nonlocal n_overflow, n_lost
            r = self._fetch(pending)
            valid, pad = r["valid"], r["pad"]
            ovf = r["overflow"] > 0
            n_overflow += int((ovf & (valid > 0) & ~(pad > 0)).sum())
            n_lost += int(((valid <= 0) & ~(pad > 0)).sum())
            self._score_batch(r["adds"], r["add"], valid, r["obj_idx"].astype(np.int64),
                              r["sym_flag"], pad, distances, class_ids, lost_per_class)

        pending = None
        for batch in loader:
            nxt = self._dispatch(batch)
            if pending is not None:
                consume(pending)
            pending = nxt
        if pending is not None:
            consume(pending)
        if self.group is not None:
            distances, class_ids, lost_per_class, n_overflow, n_lost = self._gather(
                distances, class_ids, lost_per_class, n_overflow, n_lost)
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

    def _gather(self, distances, class_ids, lost_per_class, n_overflow, n_lost):
        """Every rank's scores, in rank order, and the summed counts."""
        g = self.group
        distances = [float(v) for part in allgather_host(
            np.asarray(distances, np.float64), g) for v in part]
        class_ids = [int(v) for part in allgather_host(
            np.asarray(class_ids, np.int64), g) for v in part]
        n_cls = int(self.model_points.shape[0])
        counts = np.zeros(n_cls + 2, np.int64)
        for c, n in lost_per_class.items():
            counts[c] = n
        counts[n_cls:] = (n_overflow, n_lost)
        dev = self.device if g.backend == "nccl" else torch.device("cpu")
        counts = all_reduce_sum(torch.as_tensor(counts, device=dev), g).cpu().numpy()
        lost_per_class = {i: int(counts[i]) for i in range(n_cls) if counts[i]}
        return distances, class_ids, lost_per_class, int(counts[n_cls]), int(counts[n_cls + 1])

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
