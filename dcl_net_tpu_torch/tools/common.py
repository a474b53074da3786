"""Shared CLI scaffolding for the port's tools.

Counterpart of dcl_net_tpu/tools/common.py: argparse -> Config.fromfile ->
overrides -> run directory, logger, source backup and seeds; the model and
the training dataset from the config.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.train.logging import backup_source, get_logger, set_random_seed


def base_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--model", default="DCL_Net", help="model name")
    parser.add_argument("--config", required=True, help="path to yaml config")
    parser.add_argument("--exp_id", default=0, type=int, help="experiment id")
    parser.add_argument("--path_data", default="./datasets", help="dataset root")
    parser.add_argument("--epoch", default=None, type=int, help="checkpoint epoch (eval)")
    parser.add_argument("--checkpoint", default=None, help="explicit checkpoint path")
    parser.add_argument("--log_root", default="./log", help="log directory root")
    parser.add_argument("--override", nargs="*", default=[],
                        help="config overrides key.subkey=value")
    parser.add_argument("--n_devices", default=None, type=int,
                        help="data-parallel device count; the port runs one")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default cuda)")
    return parser


def init(args, tool_name: str) -> Tuple[object, Config]:
    """Config with overrides, run directory <log_root>/<model>_<config>_id<n>,
    logger, source backup and seeds."""
    cfg = Config.fromfile(args.config)
    if args.override:
        cfg = cfg.apply_overrides(args.override)
    config_name = os.path.splitext(os.path.basename(args.config))[0]
    exp_name = f"{args.model}_{config_name}_id{args.exp_id}"
    log_dir = os.path.join(args.log_root, exp_name)
    os.makedirs(log_dir, exist_ok=True)
    cfg.exp_name = exp_name
    cfg.log_dir = log_dir
    cfg.model_name = args.model
    cfg.path_data = args.path_data
    if args.epoch is not None:
        cfg.test_epoch = args.epoch
    logger = get_logger(path_file=os.path.join(log_dir, f"{tool_name}_logger.log"))
    backup_source(log_dir)
    set_random_seed(int(cfg.get("rd_seed", 1)))
    return logger, cfg


def build_model(cfg: Config, device=None, seed: int = 0):
    """The port's DCLNet from cfg.model, in f32. cfg.model.interp_mode
    (default "exact") picks the point-feature path: "exact" and "pallas" run
    the two-stage path (kernels K2-K5), "pallas_fused" the fused one (K2,
    K6, K7). The model keys the port does not run yet raise: compute_dtype
    bfloat16, remat, and interp_mode "local"."""
    from dcl_net_tpu_torch.models.dcl_net import DCLNet

    m = cfg.model
    if m.get("name", "DCL_Net") != "DCL_Net":
        raise NotImplementedError(f"model {m.name}: the port builds DCL_Net")
    dtype = m.get("compute_dtype")
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"compute_dtype {dtype}: the port runs f32 only")
    if m.get("remat"):
        raise NotImplementedError("model.remat: not ported yet")
    return DCLNet.from_config(m, device=device, seed=seed)


def build_train_dataset(cfg: Config):
    ds_cfg = cfg.hyper_dataset_train
    name = ds_cfg.name
    if name == "synthetic":
        from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset

        return SyntheticPoseDataset(
            n_points=int(ds_cfg.input_size),
            unit_voxel_extent=tuple(ds_cfg.unit_voxel_extent),
            voxel_num_limit=tuple(int(v) for v in ds_cfg.voxel_num_limit),
            length=int(ds_cfg.get("length", 10000)),
        )
    if name in ("ycbv_train", "linemod"):
        raise NotImplementedError(f"dataset {name}: its readers are not ported yet")
    raise KeyError(name)
