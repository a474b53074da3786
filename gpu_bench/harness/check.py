"""The comparison that decides `correct`: the program's outputs from the
timed path against the plain reference (reference/), on the same inputs
and weights, run after the window once the program's state is freed.

Each loop has its numbers, each held to its cell's limit (limits/<cell>.json):

  eval, serve  rot_gap_cond     largest |R - R_ref| entry of a row times the row's
                                conditioning (reference/model.py::ortho9d_to_matrix):
                                the change of the projection's input that the gap
                                implies, which rounding keeps near 1e-7 where the
                                gap itself grows without bound as a row's 9D
                                output nears a degenerate matrix
               trans_max_abs    largest |t - t_ref| entry, metres
               adds_gap_cond    (eval) largest |ADD-S - ADD-S_ref| / max(ADD-S_ref, 1 mm)
                                of a row, times the row's conditioning, for the
                                same reason: the scored distances
               overflow_diff    rows whose capacity-overflow flag differs (limit 0)
  train        loss_first_rel   |loss - loss_ref| / |loss_ref| of the first step; the
                                later steps' losses drift apart by rounding once Adam's
                                first updates have moved the two sides' parameters
                                apart (PERF.md), and are printed, not compared
               grad_leaf_gap    worst leaf's | |g| - |g_ref| | / max(|g_ref|, median leaf |g_ref|),
                                the first step's gradient
               change_leaf_gap  the same of each leaf's change over the checked steps

Leaves whose reference gradient is under a thousandth of the median leaf's
(rounding, as a bias under a normalisation) are left out of both leaf gaps,
by that rule on the reference's gradient, not by name.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

from gpu_bench.reference import model as ref
from gpu_bench.reference import train as ref_train

BLOCK_ROWS = 64


def _as_device(x, device):
    if isinstance(x, dict):
        return {k: _as_device(v, device) for k, v in x.items()}
    return torch.as_tensor(np.asarray(x), device=device)


@torch.no_grad()
def reference_poses(weights, model_cfg, bank, inp_feats, inp_vidx, obj_idx, device
                    ) -> Dict[str, torch.Tensor]:
    """The reference's eval-mode poses for rows, with the template branch
    encoded once per class from the bank, in blocks of BLOCK_ROWS."""
    w = weights
    b = _as_device(bank, device)
    tmp_all = ref.encode(b["feats"], b["voxel_idx"], w, "tmp", model_cfg, False)
    out: Dict[str, List[torch.Tensor]] = {"rot_pred": [], "rot_cond": [], "trans_pred": [],
                                          "overflow": []}
    n = len(obj_idx)
    for i in range(0, n, BLOCK_ROWS):
        sl = slice(i, min(n, i + BLOCK_ROWS))
        feats = torch.as_tensor(inp_feats[sl], device=device)
        vidx = torch.as_tensor(inp_vidx[sl], device=device)
        cls = torch.as_tensor(obj_idx[sl], device=device).long()
        obs = ref.encode(feats, vidx, w, "inp", model_cfg, False)
        res = ref.fuse(obs, {k: v[cls] for k, v in tmp_all.items()}, w, False)
        for k in out:
            out[k].append(res[k].float().cpu())
    return {k: torch.cat(v) for k, v in out.items()}


@torch.no_grad()
def reference_adds(model_points, obj_idx, rot, trans, rot_gt, trans_gt, device) -> torch.Tensor:
    """The reference's ADD-S of given poses, in blocks of BLOCK_ROWS."""
    out = []
    mp_all = torch.as_tensor(model_points, device=device)
    for i in range(0, len(obj_idx), BLOCK_ROWS):
        sl = slice(i, min(len(obj_idx), i + BLOCK_ROWS))
        cls = torch.as_tensor(obj_idx[sl], device=device).long()
        out.append(ref.add_s(mp_all[cls], rot[sl].to(device), trans[sl].to(device),
                             torch.as_tensor(rot_gt[sl], device=device),
                             torch.as_tensor(trans_gt[sl], device=device)).cpu())
    return torch.cat(out)


def pose_numbers(prog: Dict[str, torch.Tensor], refr: Dict[str, torch.Tensor]) -> Dict[str, float]:
    rot_gap = (prog["rot_pred"] - refr["rot_pred"]).abs().amax((1, 2))
    worst = int(rot_gap.argmax())
    print(f"rotation: largest gap {float(rot_gap[worst]):.4g} at a row of conditioning "
          f"{float(refr['rot_cond'][worst]):.4g}; conditioning over the rows: least "
          f"{float(refr['rot_cond'].min()):.4g}, median {float(refr['rot_cond'].median()):.4g}",
          file=sys.stderr, flush=True)
    nums = {
        "rot_gap_cond": float((rot_gap * refr["rot_cond"]).max()),
        "trans_max_abs": float((prog["trans_pred"] - refr["trans_pred"]).abs().max()),
        "overflow_diff": float(((prog["overflow"] > 0) != (refr["overflow"] > 0)).sum()),
    }
    if "adds" in prog and "adds" in refr:
        gap = (prog["adds"] - refr["adds"]).abs() / torch.clamp(refr["adds"], min=1e-3)
        nums["adds_gap_cond"] = float((gap * refr["rot_cond"]).max())
    return nums


def eval_numbers(loop, outputs: Dict[str, Any], device) -> Dict[str, float]:
    """Every pool batch's rows as the window first scored them, against the
    reference."""
    rows = outputs["rows"]
    keys = sorted(rows)
    pool = [loop.pool[p] for p in keys]
    cat = lambda f: np.concatenate([f(b) for b in pool])  # noqa: E731
    obj = cat(lambda b: b["labels"]["obj_idx"])
    refr = reference_poses(loop.weights, loop.cell.config["model"], loop.bank,
                           cat(lambda b: b["inp"]["feats"]),
                           cat(lambda b: b["inp"]["voxel_idx"]), obj, device)
    prog = {k: torch.cat([rows[p][k] for p in keys]) for k in rows[keys[0]]}
    refr["adds"] = reference_adds(loop.model_points, obj, refr["rot_pred"], refr["trans_pred"],
                                  cat(lambda b: b["labels"]["rot_gt"]),
                                  cat(lambda b: b["labels"]["trans_gt"]), device)
    return pose_numbers(prog, refr)


def serve_sample(frames, seed: int, count: int) -> List[int]:
    """Frames to compare: `count` drawn from the seed, the longest among
    them."""
    sizes = frames.sizes
    rng = np.random.default_rng([int(seed), 13])
    pick = set(rng.choice(len(sizes), min(count, len(sizes)), replace=False).tolist())
    pick.add(int(np.argmax(sizes)))
    return sorted(pick)


def serve_numbers(loop, outputs: Dict[str, Any], device) -> Dict[str, float]:
    """The real rows of a sample of the served frames, against the reference
    (padding rows are not outputs)."""
    frames = outputs["frames"]
    pick = serve_sample(frames, loop.seed, int(loop.cell.traffic["checked_frames"]))
    idx = np.concatenate([frames.rows[k] for k in pick])
    r = loop.rows
    refr = reference_poses(loop.weights, loop.cell.config["model"], loop.bank,
                           r["inp"]["feats"][idx], r["inp"]["voxel_idx"][idx],
                           r["labels"]["obj_idx"][idx], device)
    prog = {k: torch.cat([outputs["outputs"][f][k] for f in pick])
            for k in ("rot_pred", "trans_pred", "overflow")}
    return pose_numbers(prog, refr)


def leaf_gap(prog: List[torch.Tensor], refr: List[torch.Tensor], keep: List[bool]) -> float:
    """Worst leaf's gap of norms, against max(the reference leaf's norm, the
    median reference leaf's norm)."""
    pn = torch.stack([p.double().norm() for p in prog]).cpu()
    rn = torch.stack([r.double().norm() for r in refr]).cpu()
    kept = torch.tensor(keep)
    med = rn[kept].median()
    gap = (pn - rn).abs() / torch.clamp(rn, min=float(med))
    return float(gap[kept].max())


def checked_batches(loop, device) -> List[Dict]:
    n = int(loop.cell.traffic["checked_steps"])
    return [_as_device(b, device) for b in loop.setup_batches[:n]]


def train_numbers(loop, outputs: Dict[str, Any], device) -> Dict[str, float]:
    """The set-up's checked steps against the reference's, from the same
    weights on the same batches."""
    names = outputs["names"]
    refr = ref_train.run_steps(loop.weights, names, checked_batches(loop, device),
                               loop.cell.config)
    cond = torch.cat(refr["cond"])
    print(f"rotation conditioning of the checked steps' rows: least {float(cond.min()):.4g}, "
          f"median {float(cond.median()):.4g}", file=sys.stderr, flush=True)
    return train_gaps(loop, outputs, refr)


def train_gaps(loop, outputs: Dict[str, Any], refr: Dict[str, Any]) -> Dict[str, float]:
    names = outputs["names"]
    n = len(refr["loss_all"])
    losses = np.asarray(outputs["losses"][:n])
    ref_losses = np.asarray(refr["loss_all"])
    rel = np.abs(losses - ref_losses) / np.abs(ref_losses)
    print(f"loss gap of each checked step: {', '.join(f'{x:.3g}' for x in rel)}",
          file=sys.stderr, flush=True)
    rn = torch.stack([g.double().norm() for g in refr["grad"]])
    keep = (rn >= 1e-3 * rn.median()).tolist()
    change_p = [a - i for a, i in zip(outputs["after"], outputs["init"])]
    change_r = [a - loop.weights[k] for a, k in zip(refr["params"], names)]
    return {
        "loss_first_rel": float(rel[0]),
        "grad_leaf_gap": leaf_gap(outputs["grad"], refr["grad"], keep),
        "change_leaf_gap": leaf_gap(change_p, change_r, keep),
    }


def compare(loop, outputs: Dict[str, Any], device) -> Dict[str, float]:
    """The loop's numbers, with the reference in float32 and TF32 off."""
    ref.precision("f32")
    return NUMBERS[loop.kind](loop, outputs, device)


NUMBERS = {"eval": eval_numbers, "train": train_numbers, "serve": serve_numbers}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number with no limit fails)."""
    return all(k in limits and np.isfinite(v) and v <= float(limits[k])
               for k, v in numbers.items())
