"""Stage-2 (refiner) training CLI of the port.

Usage:
  python -m dcl_net_tpu_torch.tools.train_ycbv_stage2 \
      --config configs/config_YCBV_bs40.yaml \
      --config_stage1 configs/config_YCBV_bs32.yaml \
      --checkpoint_stage1 log/<stage-1 run>/epoch_<n> --iteration 2

Counterpart of dcl_net_tpu/tools/train_ycbv_stage2.py. The stage-1 model
is built from --config_stage1 (default: --config and its overrides) and
loaded from a checkpoint directory of the port's stage-1 trainer
(tools/train_stage1.py) or from a reference .pth; it runs frozen. The
refiner trains on the config's dataset with its optimizer and schedule, in
batches of bs // iteration as in the reference, through the same Solver
services as stage 1: logging, epoch_<n>/ checkpoints of the refiner,
resume, and every cfg.per_val epochs the refined ADD-S on a fixed probe
batch drawn with seed rd_seed + 977 (training data: a monitoring signal,
not a test metric).
"""

from __future__ import annotations


def main(argv=None) -> None:
    import numpy as np
    import torch

    from dcl_net_tpu_torch import resolve_device, strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.eval.metrics import add_s_batch
    from dcl_net_tpu_torch.models.refiner import Refiner, refine_pose
    from dcl_net_tpu_torch.tools.common import (
        base_parser, build_model, build_train_dataset, init, load_model_weights,
        refuse_data_parallel,
    )
    from dcl_net_tpu_torch.train.checkpoints import latest_checkpoint
    from dcl_net_tpu_torch.train.logging import ScalarWriter, parameter_count
    from dcl_net_tpu_torch.train.solver import Solver
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    parser = base_parser("DCL-Net stage-2 refiner training (PyTorch)")
    parser.add_argument("--iteration", default=2, type=int)
    parser.add_argument("--config_stage1", default=None)
    parser.add_argument("--checkpoint_stage1", required=True,
                        help="epoch_<n> directory of a stage-1 run of the port, "
                        "or a reference .pth")
    args = parser.parse_args(argv)
    refuse_data_parallel(args)
    logger, cfg = init(args, "train_ycbv_stage2")
    strict_f32()
    device = resolve_device(args.device)
    seed = int(cfg.get("rd_seed", 1))

    cfg_stage1 = Config.fromfile(args.config_stage1) if args.config_stage1 else cfg
    main_model = build_model(cfg_stage1, device=device, seed=seed)
    load_model_weights(main_model, args.checkpoint_stage1)
    main_model.eval()

    dataset = build_train_dataset(cfg)
    dl = cfg.hyper_dataloader_train
    bs = max(int(dl.bs) // args.iteration, 1)
    loader = BatchLoader(
        dataset, batch_size=bs, shuffle=bool(dl.get("shuffle", True)),
        drop_last=bool(dl.get("drop_last", True)),
        num_workers=int(dl.get("num_workers", 8)), seed=seed)
    # the CAD clouds of the ADD-S loss, as the JAX tool takes them: the
    # eval clouds where the dataset has them, else the YCB-V training
    # reader's CAD draws (mm -> m), else the synthetic clouds
    if hasattr(dataset, "model_points_array"):
        cld = dataset.model_points_array()
    elif hasattr(dataset, "pc_cad"):
        cld = np.stack([dataset.pc_cad[c] / 1000.0 for c in sorted(dataset.pc_cad)])
    else:
        n_tmp = int(cfg.model.n_tmp)
        cld = np.stack([dataset.model_points(c, n_tmp)
                        for c in range(len(dataset.cad_points))])
    cld = torch.as_tensor(np.asarray(cld, np.float32), device=device)
    refiner = Refiner(n_inp=int(cfg.model.n_inp), device=device, seed=seed)

    probe_idx = np.random.RandomState(seed + 977).choice(
        len(dataset), size=min(bs, len(dataset)), replace=False)
    probe = batch_to_torch(make_batch([dataset[int(i)] for i in probe_idx],
                                      pad_to=bs).to_dict(), device)

    def eval_fn(state, epoch):
        refiner.eval()
        with torch.inference_mode():
            out = main_model(probe)
            rot, trans = refine_pose(refiner, out["points_inp"], out["F_Xo_p"],
                                     out["conf"], out["rot_pred"], out["trans_pred"],
                                     args.iteration)
            labels = probe["labels"]
            adds = add_s_batch(cld[labels["obj_idx"].long()], rot, trans,
                               labels["rot_gt"], labels["trans_gt"])
            valid = probe["valid"]
            mean = torch.sum(adds * valid) / torch.clamp(valid.sum(), min=1.0)
        return {"refined_adds_mean": float(mean)}

    writer = ScalarWriter(cfg.log_dir)
    solver = Solver(
        refiner, None, cfg, loader, logger=logger, checkpoint_dir=cfg.log_dir,
        writer=writer, device=device, eval_fn=eval_fn,
        step_builder=lambda opt: make_stage2_train_step(
            main_model, refiner, opt, args.iteration, cld))
    solver.initialize()
    logger.warning(f"#Refiner parameters : {parameter_count(refiner)}")
    resume = latest_checkpoint(cfg.log_dir)
    if resume:
        logger.warning(f"resuming from {resume}")
        solver.restore(resume)
    solver.solve()
    writer.close()
    logger.warning("stage-2 training done")


if __name__ == "__main__":
    main()
