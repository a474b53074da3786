"""Stage-1 training CLI of the port.

Usage:
  python -m dcl_net_tpu_torch.tools.train_stage1 --config configs/config_YCBV_bs32.yaml
  python -m dcl_net_tpu_torch.tools.train_stage1 \
      --config configs/config_synthetic_smoke.yaml --device cpu \
      --override model.voxel_num_limit=[16,16,16] ...

Trains on the config's dataset with its optimizer and schedule, writes
<log_root>/<model>_<config>_id<exp_id>/ (logger, scalars.jsonl, epoch_<n>/
checkpoints) and resumes from the newest checkpoint there.
cfg.train_template_bank encodes the per-class template bank once per step.
hyper_dataloader_train.worker_type picks thread or process workers;
hyper_dataset_train.device_preprocess runs the reader's numpy tail on the
device (data/device_preprocess.py) in the loader's producer thread, and
samples_per_frame then draws that many instances from each decoded frame.
Process workers need a __main__ that is a file (python -m or a script):
forkserver imports it in each worker.

Data parallelism: --n_devices N trains on N local ranks, one process per
GPU (--device cpu: gloo ranks on the CPU), --coordinator / --num_hosts /
--host_id across hosts, or under torchrun (tools/common.py). The config's
bs is the global batch; each rank loads its block of it, and the ranks'
steps equal one process's step on the global batch (parallel/mesh.py).
Rank 0 logs and writes the checkpoints. At the end each rank logs the
sha256 of its parameters (train/logging.py::parameter_digest), which must be
the same on every rank.
"""

from __future__ import annotations


def main(argv=None) -> None:
    from dcl_net_tpu_torch.tools.common import base_parser, run_tool

    args = base_parser("DCL-Net stage-1 training (PyTorch)").parse_args(argv)
    return run_tool(args, argv, main, _train)


def _train(args, group, device) -> None:
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.models.dcl_net import dcl_losses
    from dcl_net_tpu_torch.tools.common import (
        build_device_preprocess, build_model, build_train_dataset, init, process_stride,
    )
    from dcl_net_tpu_torch.train.checkpoints import latest_checkpoint
    from dcl_net_tpu_torch.train.logging import (
        ScalarWriter, parameter_count, parameter_digest,
    )
    from dcl_net_tpu_torch.train.solver import Solver

    logger, cfg = init(args, "train_stage1", group)
    logger.warning("*" * 20 + " Start Logging " + "*" * 20)
    logger.info(str(cfg.to_dict()))
    if group is not None:
        logger.warning(f"data-parallel rank {group.rank} of {group.world} on {device} "
                       f"({group.backend}): per-rank batch "
                       f"{int(cfg.hyper_dataloader_train.bs) // group.world}")
    strict_f32()
    seed = int(cfg.get("rd_seed", 1))

    logger.info("=> creating model ...")
    model = build_model(cfg, device=device, seed=seed)
    dataset = build_train_dataset(cfg)
    collate, transform = build_device_preprocess(
        cfg.hyper_dataset_train, dataset, augment=True, seed=seed, device=device,
        logger=logger, group=group)
    dl = cfg.hyper_dataloader_train
    loader = BatchLoader(
        dataset, batch_size=int(dl.bs), shuffle=bool(dl.get("shuffle", True)),
        drop_last=bool(dl.get("drop_last", True)),
        num_workers=int(dl.get("num_workers", 8)), seed=seed,
        worker_type=str(dl.get("worker_type", "thread")), collate=collate,
        batch_transform=transform,
        samples_per_item=getattr(dataset, "samples_per_frame", 1), **process_stride(group))
    writer = ScalarWriter(cfg.log_dir) if group is None or group.is_main else None
    bank = None
    if cfg.get("train_template_bank") and hasattr(dataset, "template_bank"):
        bank = dataset.template_bank()
        logger.warning(f"banked-template training: {bank['feats'].shape[0]} "
                       "classes encoded once per step")
    solver = Solver(model, dcl_losses, cfg, loader, logger=logger,
                    checkpoint_dir=cfg.log_dir, writer=writer,
                    template_bank=bank, device=device, group=group)
    solver.initialize()
    logger.warning(f"#Total parameters : {parameter_count(model)}")
    resume = latest_checkpoint(cfg.log_dir)
    if resume:
        logger.warning(f"resuming from {resume}")
        solver.restore(resume)
    try:
        solver.solve()
    finally:
        loader.close()
        if writer is not None:
            writer.close()
    if group is not None:
        logger.warning(f"rank {group.rank} of {group.world}: parameters sha256 "
                       f"{parameter_digest(model)}")
    logger.warning("training done")


if __name__ == "__main__":
    main()
