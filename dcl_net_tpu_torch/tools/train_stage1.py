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
"""

from __future__ import annotations


def main(argv=None) -> None:
    from dcl_net_tpu_torch import resolve_device, strict_f32
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.models.dcl_net import dcl_losses
    from dcl_net_tpu_torch.tools.common import (
        base_parser, build_model, build_train_dataset, init,
    )
    from dcl_net_tpu_torch.train.checkpoints import latest_checkpoint
    from dcl_net_tpu_torch.train.logging import ScalarWriter, parameter_count
    from dcl_net_tpu_torch.train.solver import Solver

    args = base_parser("DCL-Net stage-1 training (PyTorch)").parse_args(argv)
    n_devices = args.n_devices
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError("--n_devices > 1: data parallelism is not ported yet")
    logger, cfg = init(args, "train_stage1")
    logger.warning("*" * 20 + " Start Logging " + "*" * 20)
    logger.info(str(cfg.to_dict()))
    strict_f32()
    device = resolve_device(args.device)
    seed = int(cfg.get("rd_seed", 1))

    logger.info("=> creating model ...")
    model = build_model(cfg, device=device, seed=seed)
    dataset = build_train_dataset(cfg)
    dl = cfg.hyper_dataloader_train
    loader = BatchLoader(
        dataset, batch_size=int(dl.bs), shuffle=bool(dl.get("shuffle", True)),
        drop_last=bool(dl.get("drop_last", True)),
        num_workers=int(dl.get("num_workers", 8)), seed=seed)
    writer = ScalarWriter(cfg.log_dir)
    bank = None
    if cfg.get("train_template_bank") and hasattr(dataset, "template_bank"):
        bank = dataset.template_bank()
        logger.warning(f"banked-template training: {bank['feats'].shape[0]} "
                       "classes encoded once per step")
    solver = Solver(model, dcl_losses, cfg, loader, logger=logger,
                    checkpoint_dir=cfg.log_dir, writer=writer,
                    template_bank=bank, device=device)
    solver.initialize()
    logger.warning(f"#Total parameters : {parameter_count(model)}")
    resume = latest_checkpoint(cfg.log_dir)
    if resume:
        logger.warning(f"resuming from {resume}")
        solver.restore(resume)
    solver.solve()
    writer.close()
    logger.warning("training done")


if __name__ == "__main__":
    main()
