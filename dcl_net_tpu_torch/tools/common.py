"""Shared CLI scaffolding for the port's tools.

Counterpart of dcl_net_tpu/tools/common.py: argparse -> Config.fromfile ->
overrides -> run directory, logger, source backup and seeds; the model, the
training dataset (synthetic, YCB-V or LineMOD), the device preprocessing of
a dataset's raw-candidate mode, the YCB-V eval dataset and loader and the
instance loader of the LineMOD eval sets from the config; model weights from
a checkpoint of the port or a reference .pth; the eval tools' result file;
the data-parallel launch (run_tool).

Data parallelism (parallel/mesh.py), one process per device:
- `--n_devices N` starts N local ranks (spawned processes, rank r on
  cuda:r, or on the CPU with --device cpu), which meet through a file://
  rendezvous in a temporary directory; fewer than N visible GPUs raises.
  Without the flag, the config's parallel.n_devices (default 1) is N, as
  the JAX tools' build_mesh reads it;
- `--coordinator host:port --num_hosts H --host_id h` joins a world of H
  hosts: with --n_devices N each host starts its N local ranks into a
  world of H*N (ranks h*N + r), without it this process is the host's one
  rank;
- torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
  MASTER_PORT) makes this process that rank (init env://).
NCCL joins CUDA ranks, gloo CPU ranks.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Tuple

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
                        help="data-parallel ranks on this host, one process per "
                        "device (default 1)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host: the rendezvous host:port (or tcp:// / "
                        "file:// init method) of every host's ranks")
    parser.add_argument("--num_hosts", default=None, type=int,
                        help="multi-host: the number of hosts")
    parser.add_argument("--host_id", default=None, type=int,
                        help="multi-host: this host's index")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default cuda)")
    return parser


def _rank_main(local_rank: int, main: Callable, argv, world: int, first_rank: int,
               rendezvous: str, out: str):
    """A local rank started by launch_local_ranks: torchrun's variables and
    the rendezvous in the environment, then the tool; local rank 0 leaves
    its result in `out` for the launching process."""
    import pickle

    from dcl_net_tpu_torch.parallel.mesh import ENV_INIT

    os.environ.update({"WORLD_SIZE": str(world), "RANK": str(first_rank + local_rank),
                       "LOCAL_RANK": str(local_rank), ENV_INIT: rendezvous})
    result = main(argv)
    if local_rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


def local_rank_count(args) -> int:
    """This host's ranks: --n_devices, else the config's parallel.n_devices
    (with the --override's applied), else 1."""
    if args.n_devices is not None:
        return int(args.n_devices)
    cfg = Config.fromfile(args.config)
    if args.override:
        cfg = cfg.apply_overrides(args.override)
    return int(cfg.get("parallel", Config()).get("n_devices", 1))


def launch_local_ranks(args, main: Callable, argv):
    """With N = local_rank_count(args) > 1 (--n_devices, or the config's
    parallel.n_devices), in a process that is not a rank already:
    start this host's N ranks, each running main(argv), and return
    (True, local rank 0's return value) once all have ended; a rank that
    fails ends the others and raises here. Otherwise (False, None).
    N GPUs must be visible unless --device cpu."""
    import pickle
    import shutil
    import tempfile

    import torch

    from dcl_net_tpu_torch import resolve_device
    from dcl_net_tpu_torch.parallel.mesh import env_rank, init_method

    if env_rank() is not None:
        return False, None
    n = local_rank_count(args)
    if n <= 1:
        return False, None
    if resolve_device(args.device).type == "cuda" and torch.cuda.device_count() < n:
        where = "--n_devices" if args.n_devices is not None else "parallel.n_devices"
        raise ValueError(f"{where} {n}: only {torch.cuda.device_count()} GPUs are "
                         "visible (one rank a GPU)")
    if args.coordinator and (args.num_hosts is None or args.host_id is None):
        raise ValueError("--coordinator needs --num_hosts and --host_id")
    hosts, host = args.num_hosts or 1, args.host_id or 0
    tmp = tempfile.mkdtemp(prefix="dclx_ranks_")
    try:
        rendezvous = (init_method(args.coordinator) if args.coordinator
                      else "file://" + os.path.join(tmp, "rendezvous"))
        out = os.path.join(tmp, "result.pkl")
        torch.multiprocessing.start_processes(
            _rank_main, args=(main, argv, hosts * n, host * n, rendezvous, out),
            nprocs=n, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return True, pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_group(args):
    """This process's data-parallel group (parallel/mesh.py::Group), or
    None outside a data-parallel launch: a rank of launch_local_ranks or
    torchrun takes cuda:LOCAL_RANK (or the CPU), a lone --coordinator
    process is its host's one rank."""
    import torch

    from dcl_net_tpu_torch import resolve_device
    from dcl_net_tpu_torch.parallel.mesh import env_rank, init_distributed

    device = resolve_device(args.device)
    rank = env_rank()
    if rank is None:
        if not args.coordinator:
            return None
        if args.num_hosts is None or args.host_id is None:
            raise ValueError("--coordinator needs --num_hosts and --host_id")
        return init_distributed(args.coordinator, args.num_hosts, args.host_id,
                                device=device)
    if device.type == "cuda":
        if rank["local_rank"] >= torch.cuda.device_count():
            raise ValueError(f"local rank {rank['local_rank']}: only "
                             f"{torch.cuda.device_count()} GPUs are visible")
        device = torch.device("cuda", rank["local_rank"])
    return init_distributed(rank["init"], rank["world"], rank["rank"], device=device)


def run_tool(args, argv, main: Callable, body: Callable):
    """Run a tool's body(args, group, device) in this process, as the
    single process or as one rank of a data-parallel launch (the module
    docstring), or start the local ranks that run main(argv) and return
    local rank 0's result. The process group is left at the end."""
    from dcl_net_tpu_torch import resolve_device
    from dcl_net_tpu_torch.parallel.mesh import destroy

    launched, result = launch_local_ranks(args, main, argv)
    if launched:
        return result
    group = build_group(args)
    try:
        return body(args, group, group.device if group else resolve_device(args.device))
    finally:
        destroy(group)


def init(args, tool_name: str, group=None) -> Tuple[object, Config]:
    """Config with overrides, run directory <log_root>/<model>_<config>_id<n>,
    logger, source backup and seeds. Of a data-parallel group, rank 0
    alone writes the log file and the source backup; the other ranks log
    warnings to the console."""
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
    if group is None or group.is_main:
        logger = get_logger(path_file=os.path.join(log_dir, f"{tool_name}_logger.log"))
        backup_source(log_dir)
    else:
        logger = get_logger(level_print=logging.WARNING)
    set_random_seed(int(cfg.get("rd_seed", 1)))
    return logger, cfg


def build_model(cfg: Config, device=None, seed: int = 0):
    """The port's DCLNet from cfg.model. cfg.model.interp_mode (default
    "exact") picks the point-feature path: "exact" and "pallas" run the
    two-stage path (kernels K2-K5), "pallas_fused" the fused one (K2, K6,
    K7). cfg.model.compute_dtype "float32" (the default) or "bfloat16"
    picks the feature compute type; a bf16 model evaluates through the bf16
    variants of K1, K2, K3 and K6 and trains through those of K4, K5 and
    K7, its parameters kept in f32 (so a checkpoint of either type loads
    into either). cfg.model.remat recomputes the backbones' activations in
    the backward (models/dcl_net.py). interp_mode "local" runs the
    windowed 3-NN on the dense grids (ops/grid_interp.py) after K1, and
    model.voxelization_mode takes 0-4 (models/dcl_net.py).

    The class is cfg.model.name (default "DCL_Net") in the registry MODELS,
    as the JAX package resolves it: an unknown name raises the registry's
    KeyError, which lists the registered names."""
    import dcl_net_tpu_torch.models  # noqa: F401  (fills the registry)
    from dcl_net_tpu_torch.registry import MODELS

    m = cfg.model
    model_cls = MODELS.get(m.get("name", cfg.get("model_name", "DCL_Net")))
    return model_cls.from_config(m, device=device, seed=seed)


def build_device_preprocess(ds_cfg, dataset, *, augment: bool, eval_keep_clamp: bool = False,
                            keep_clamp_threshold: int = 32, seed: int = 1, device=None,
                            logger=None, group=None):
    """(collate, batch_transform) of device-side preprocessing when
    ds_cfg.device_preprocess is set, else (None, None): make_raw_batch and
    a DevicePreprocessor on `device` (data/device_preprocess.py). The
    device filter's validity threshold is the dataset's device_min_points
    (YCB-V train 50, LM 128, LMO 0, each reference loader's min_keep); the
    eval keep-clamp and its threshold come from the caller (YCB-V test
    32, LM eval 0, LMO none). Over a data-parallel group each rank draws
    its own stream (DevicePreprocessor's process_id)."""
    if not bool(ds_cfg.get("device_preprocess", False)):
        return None, None
    if not getattr(dataset, "raw_mode", False):
        raise ValueError("device_preprocess needs a dataset with a raw-candidate mode, "
                         f"got {type(dataset).__name__}")
    from dcl_net_tpu_torch.data.device_preprocess import DevicePreprocessor, make_raw_batch

    transform = DevicePreprocessor(
        n_points=int(ds_cfg.input_size),
        unit_voxel_extent=tuple(ds_cfg.unit_voxel_extent),
        voxel_num_limit=tuple(int(v) for v in ds_cfg.voxel_num_limit),
        augment=augment, min_points=int(dataset.device_min_points),
        eval_keep_clamp=eval_keep_clamp, keep_clamp_threshold=keep_clamp_threshold,
        seed=seed, device=device, **process_stride(group))
    if logger is not None:
        logger.warning("device-side preprocessing: lift/center" + ("/aug" if augment else "")
                       + f"/filter/resample on {transform.device} (cand_k={dataset.cand_k})")
    return make_raw_batch, transform


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


def process_stride(group) -> dict:
    """The loaders' and DevicePreprocessor's process_id and process_count
    for a data-parallel group (None: one process)."""
    if group is None:
        return {"process_id": 0, "process_count": 1}
    return {"process_id": group.rank, "process_count": group.world}


def build_ycbv_eval(cfg: Config, device=None, logger=None, group=None):
    """The YCB-V test dataset of cfg.hyper_dataset_test and its
    EvalFrameLoader at hyper_dataloader_test's bs, num_workers and
    worker_type; with hyper_dataset_test.device_preprocess, the raw
    candidates go through device preprocessing on `device` with YCB-V
    test's keep-clamp at 32 (reference YCBV/dataloader_test_YCBV.py:
    164-180). Over a data-parallel group the loader yields this rank's
    block of each global batch of bs rows."""
    from dcl_net_tpu_torch.data.loader import EvalFrameLoader
    from dcl_net_tpu_torch.data.ycbv import YCBVTestDataset

    ds_cfg = cfg.hyper_dataset_test
    root, assets = ycbv_dirs(cfg)
    dataset = YCBVTestDataset(ds_cfg, root, assets_dir=assets)
    collate, transform = build_device_preprocess(
        ds_cfg, dataset, augment=False, eval_keep_clamp=True, keep_clamp_threshold=32,
        seed=int(cfg.get("rd_seed", 1)), device=device, logger=logger, group=group)
    dl = cfg.hyper_dataloader_test
    loader = EvalFrameLoader(
        dataset, batch_size=int(dl.get("bs", 256)),
        num_workers=int(dl.get("num_workers", 8)),
        worker_type=str(dl.get("worker_type", "thread")),
        collate=collate, batch_transform=transform, **process_stride(group))
    return dataset, loader


def build_instance_eval_loader(cfg: Config, dataset, device=None, logger=None,
                               group=None, **keep_clamp):
    """The data/loader.py::BatchLoader of an instance-style eval dataset
    (LineMOD, Occlusion-LineMOD): dataset order, every row, the last batch
    padded, at hyper_dataloader_test's bs, num_workers and worker_type;
    with hyper_dataset_test.device_preprocess, the raw candidates go
    through device preprocessing on `device`, keep_clamp being
    build_device_preprocess's eval_keep_clamp and keep_clamp_threshold.
    Over a data-parallel group it yields this rank's block of each global
    batch, the last one filled with pad rows."""
    from dcl_net_tpu_torch.data.loader import BatchLoader

    collate, transform = build_device_preprocess(
        cfg.hyper_dataset_test, dataset, augment=False, seed=int(cfg.get("rd_seed", 1)),
        device=device, logger=logger, group=group, **keep_clamp)
    dl = cfg.hyper_dataloader_test
    return BatchLoader(dataset, batch_size=int(dl.get("bs", 256)), shuffle=False,
                       drop_last=False, num_workers=int(dl.get("num_workers", 8)),
                       worker_type=str(dl.get("worker_type", "thread")),
                       collate=collate, batch_transform=transform, fill_tail=True,
                       **process_stride(group))


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


def write_result_json(cfg: Config, tool_name: str, result: dict, group=None) -> str:
    """Persist an eval CLI's metric dict as `<log_dir>/results_<tool>.json`
    (of a data-parallel group, rank 0 writes it; every rank returns its
    path).

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
    if group is not None and not group.is_main:
        return path
    with open(path, "w") as f:
        json.dump(clean(result), f, indent=1)
    return path
