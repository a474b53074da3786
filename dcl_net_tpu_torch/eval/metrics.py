"""Pose-estimation metrics for the YCB-V protocol.

Counterpart of dcl_net_tpu/eval/metrics.py: ADD-S distances run batched on
the device in PyTorch; the VOCap AUC aggregation (0.1 m cap, x10) is numpy
on the host, copied from the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dcl_net_tpu_torch.geometry.transform import pairwise_sq_dist, transform_points


def add_s_batch(model_points: torch.Tensor, rot_pred: torch.Tensor,
                trans_pred: torch.Tensor, rot_gt: torch.Tensor,
                trans_gt: torch.Tensor) -> torch.Tensor:
    """ADD-S: mean nearest-point distance between the predicted- and
    ground-truth-posed CAD clouds. [B, P, 3] -> [B]."""
    pred = transform_points(model_points, rot_pred, trans_pred)
    gt = transform_points(model_points, rot_gt, trans_gt)
    d = torch.sqrt(pairwise_sq_dist(pred, gt) + 1e-12)
    return d.min(dim=-1).values.mean(dim=-1)


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOCap with the 0.1 m cap and x10 scaling."""
    idx = np.where(rec != np.inf)
    if len(idx[0]) == 0:
        return 0.0
    rec = rec[idx]
    prec = prec[idx]
    mrec = np.array([0.0] + list(rec) + [0.1])
    mpre = np.array([0.0] + list(prec) + [prec[-1]])
    for i in range(1, mpre.shape[0]):
        mpre[i] = max(mpre[i], mpre[i - 1])
    i = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[i] - mrec[i - 1]) * mpre[i]) * 10)


def auc_and_acc(distances: Sequence[float], max_dis: float = 0.1,
                acc_threshold: float = 0.02) -> Tuple[float, float]:
    """Per-class AUC (x100) and <threshold accuracy (x100); inf = lost."""
    d = np.asarray(list(distances), dtype=np.float64)
    if d.size == 0:
        return 0.0, 0.0
    d = d.copy()
    d[d > max_dis] = np.inf
    d = np.sort(d)
    n = d.size
    # float32 cumulative curve, as the original evaluation script builds it
    acc = np.cumsum(np.ones(n, dtype=np.float32)) / n
    aps = voc_ap(d, acc)
    acc_t = float((d < acc_threshold).sum() / n)
    return aps * 100.0, acc_t * 100.0


def per_class_auc_acc(distances: Sequence[float], class_ids: Sequence[int],
                      num_classes: int = 21, logger=None) -> Dict[str, object]:
    """Per-class ADD-S AUC and <2 cm accuracy, and their means."""
    d = np.asarray(list(distances))
    c = np.asarray(list(class_ids))
    aucs, accs = [], []
    for idx in range(num_classes):
        auc, acc = auc_and_acc(d[c == idx])
        aucs.append(auc)
        accs.append(acc)
        if logger:
            logger.warning(
                "NO.%02d | ADDS_AUC:%3.2f | ADDS<2cm:%3.2f" % (idx + 1, auc, acc))
    auc_mean = round(float(np.mean(aucs)), 2)
    acc_mean = round(float(np.mean(accs)), 2)
    if logger:
        logger.warning("MEAN  | ADDS_AUC:%3.2f | ACC<2cm:%3.2f" % (auc_mean, acc_mean))
    return {
        "auc_per_class": aucs,
        "acc_per_class": accs,
        "auc_mean": auc_mean,
        "acc_mean": acc_mean,
    }
