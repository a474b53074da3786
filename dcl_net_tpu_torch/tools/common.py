"""Shared CLI scaffolding for the port's tools.

Counterpart of dcl_net_tpu/tools/common.py: argparse -> Config.fromfile ->
overrides -> run directory, logger, source backup and seeds; the model, the
training dataset (synthetic, YCB-V or LineMOD), the YCB-V eval dataset and
loader and the instance loader of the LineMOD eval sets from the config; model
weights from a checkpoint of the port or a reference .pth; the eval tools'
result file.
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
    if name == "ycbv_train":
        from dcl_net_tpu_torch.data.ycbv import YCBVTrainDataset

        root, assets = ycbv_dirs(cfg)
        return YCBVTrainDataset(ds_cfg, root, assets_dir=assets)
    if name == "linemod":
        from dcl_net_tpu_torch.data.linemod import LineMODDataset

        return LineMODDataset("train", ds_cfg, lm_root(cfg))
    raise KeyError(name)


def lm_root(cfg: Config) -> str:
    """The LineMOD tree under cfg.path_data."""
    return os.path.join(cfg.path_data, "Linemod_preprocessed")


def ycbv_dirs(cfg: Config) -> Tuple[str, str]:
    """(frames root, assets directory) of YCB-V under cfg.path_data."""
    assets = os.path.join(cfg.path_data, "YCB_Video_Dataset")
    return os.path.join(assets, "root"), assets


def build_ycbv_eval(cfg: Config):
    """The YCB-V test dataset of cfg.hyper_dataset_test and its
    EvalFrameLoader at hyper_dataloader_test's bs and num_workers.
    device_preprocess and process workers raise: not ported yet."""
    from dcl_net_tpu_torch.data.loader import EvalFrameLoader
    from dcl_net_tpu_torch.data.ycbv import YCBVTestDataset

    ds_cfg = cfg.hyper_dataset_test
    if ds_cfg.get("device_preprocess", False):
        raise NotImplementedError(
            "hyper_dataset_test.device_preprocess: device-side preprocessing "
            "is not ported yet")
    root, assets = ycbv_dirs(cfg)
    dataset = YCBVTestDataset(ds_cfg, root, assets_dir=assets)
    dl = cfg.hyper_dataloader_test
    loader = EvalFrameLoader(
        dataset, batch_size=int(dl.get("bs", 256)),
        num_workers=int(dl.get("num_workers", 8)),
        worker_type=str(dl.get("worker_type", "thread")))
    return dataset, loader


def build_instance_eval_loader(cfg: Config, dataset):
    """The data/loader.py::BatchLoader of an instance-style eval dataset
    (LineMOD, Occlusion-LineMOD): dataset order, every row, the last batch
    padded, at hyper_dataloader_test's bs and num_workers threads. Process
    workers raise: not ported yet."""
    from dcl_net_tpu_torch.data.loader import BatchLoader

    dl = cfg.hyper_dataloader_test
    if str(dl.get("worker_type", "thread")) != "thread":
        raise NotImplementedError(
            f"worker_type {dl.worker_type!r}: the port's loaders run thread workers only")
    return BatchLoader(dataset, batch_size=int(dl.get("bs", 256)), shuffle=False,
                       drop_last=False, num_workers=int(dl.get("num_workers", 8)))


def load_model_weights(model, path: str):
    """Fill `model` (the port's DCLNet or Refiner) from `path` and return
    it: a reference .pth / .pt through the converter
    (train/checkpoints.py::load_reference_weights), else the "model" state
    dict of a checkpoint directory of the port."""
    from dcl_net_tpu_torch.train.checkpoints import load_checkpoint, load_reference_weights

    if path.endswith((".pth", ".pt")):
        return load_reference_weights(model, path)
    model.load_state_dict(load_checkpoint(path)["model"])
    return model


def refuse_data_parallel(args) -> None:
    if args.n_devices is not None and args.n_devices > 1:
        raise NotImplementedError("--n_devices > 1: data parallelism is not ported yet")


def write_result_json(cfg: Config, tool_name: str, result: dict) -> str:
    """Persist an eval CLI's metric dict as `<log_dir>/results_<tool>.json`.

    The reference tools only print metrics into their logs
    (tools/test_YCBV_stage1.py:199-205); this is the machine-readable
    artifact. numpy scalars/arrays are converted to plain JSON types."""
    import json

    import numpy as np

    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (np.floating, np.integer, np.bool_)):
            return x.item()
        return x

    path = os.path.join(cfg.log_dir, f"results_{tool_name}.json")
    with open(path, "w") as f:
        json.dump(clean(result), f, indent=1)
    return path
