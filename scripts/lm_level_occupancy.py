#!/usr/bin/env python3
"""K2's rows per pyramid level (the occupied voxels the compaction keeps)
for the LineMOD readers' samples, counted on the CPU without running the
model: each sample's voxel mask goes through the backbone's mask path (a
regular conv dilates it by its kernel footprint, a submanifold conv keeps
it, each module ends in a stride-2 pool), beside the count that pools the
point mask alone (no dilation), which understates the rows.

Usage:
  python3 scripts/lm_level_occupancy.py PATH_DATA [--dataset lm|lmo]
      [--config configs/config_LM.yaml] [--rows 512]

PATH_DATA holds Linemod_preprocessed/ (and OCCLUSION_LINEMOD/, LMO_Masks/
for lmo), as for tools/test_lm.py. Reads rows 0 .. rows-1 of the eval
reader in order after seeding the global generators with the config's
rd_seed, the draws tools/test_lm.py makes with one loader thread, and the
template bank; prints per level the mean / max over the valid rows and how
many rows exceed the level's capacity (the config's model.capacities or
the model's defaults). Counts only: no time is measured.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from dcl_net_tpu_torch.config import Config  # noqa: E402
from dcl_net_tpu_torch.data import linemod  # noqa: E402
from dcl_net_tpu_torch.models.dcl_net import DCLNet  # noqa: E402
from dcl_net_tpu_torch.ops.sparse_conv import dilate_mask, sparse_avg_pool  # noqa: E402
from dcl_net_tpu_torch.train.logging import set_random_seed  # noqa: E402


def level_rows(voxel_idx: np.ndarray, model: DCLNet, dilate: bool) -> np.ndarray:
    """[B, N, 3] voxel indices -> [B, 4] occupied cells of the pooled levels."""
    bb = model.backbone_inp
    b = voxel_idx.shape[0]
    m = torch.zeros((b,) + tuple(model.grid_shape))
    v = torch.from_numpy(voxel_idx).long()
    m[torch.arange(b)[:, None], v[..., 0], v[..., 1], v[..., 2]] = 1
    rows = []
    for i in range(bb.n_layers):
        if dilate and not getattr(bb, f"conv{i}").subm:
            m = dilate_mask(m, bb.kernel_size)
        if i in bb.module_end:
            _, m = sparse_avg_pool(m[..., None], m, bb.kernel_size, 2)
            rows.append((m > 0).reshape(b, -1).sum(1))
    return torch.stack(rows, 1).numpy()


def report(name: str, rows: np.ndarray, caps) -> str:
    return f"{name}: " + ", ".join(
        f"{r.mean():.1f} / {r.max()} ({int((r > c).sum())} over {c})"
        for r, c in zip(rows.T, caps))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path_data")
    parser.add_argument("--dataset", choices=("lm", "lmo"), default="lm")
    parser.add_argument("--config", default="configs/config_LM.yaml")
    parser.add_argument("--rows", type=int, default=512)
    args = parser.parse_args()
    cfg = Config.fromfile(args.config)
    model = DCLNet.from_config(cfg.model, device="cpu")
    caps = [min(c, int(np.prod(model.grid_shape)) // 8 ** (k + 1))
            for k, c in enumerate(model.point_feats_inp.capacities)]
    lm_root = os.path.join(args.path_data, "Linemod_preprocessed")
    if args.dataset == "lm":
        ds = linemod.LineMODDataset("eval", cfg.hyper_dataset_test, lm_root)
    else:
        ds = linemod.OcclusionLineMODDataset(
            "eval", cfg.hyper_dataset_test, os.path.join(args.path_data, "OCCLUSION_LINEMOD"),
            os.path.join(lm_root, "models"), masks_dir=os.path.join(args.path_data, "LMO_Masks"))
    set_random_seed(int(cfg.get("rd_seed", 1)))
    samples = [ds[i] for i in range(min(args.rows, len(ds)))]
    vidx = np.stack([s["inp_voxel_idx"] for s in samples if s["valid"] > 0])
    bank = ds.template_bank()["voxel_idx"]
    print(f"{args.dataset}: {len(vidx)} valid rows of {len(samples)}, {len(bank)} templates; "
          f"K2 rows per level, mean / max (rows over the capacity)")
    for dilate, what in ((True, "through the backbone's mask path"),
                         (False, "point mask pooled alone")):
        obs = np.concatenate([level_rows(vidx[i:i + 32], model, dilate)
                              for i in range(0, len(vidx), 32)])
        print(f"  {what}:")
        print("    " + report("observed", obs, caps))
        print("    " + report("template", level_rows(bank, model, dilate), caps))


if __name__ == "__main__":
    main()
