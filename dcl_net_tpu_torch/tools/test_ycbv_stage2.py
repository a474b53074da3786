"""YCB-Video stage-2 (refined) eval CLI of the port (reference
tools/test_YCBV_stage2.py).

Usage:
  python -m dcl_net_tpu_torch.tools.test_ycbv_stage2 \
      --config configs/config_YCBV_bs40.yaml \
      --checkpoint_stage1 log/<stage-1 run>/epoch_<n> \
      --checkpoint log/<stage-2 run>/epoch_<m> --iteration 2

Counterpart of dcl_net_tpu/tools/test_ycbv_stage2.py. The stage-1 model
(from the config's model section) is loaded from --checkpoint_stage1 and
the refiner from --checkpoint (default <log_dir>/epoch_<test_epoch>), each
a checkpoint directory of the port or a reference .pth; every instance's
stage-1 pose is refined --iteration times and scored by ADD-S as in
test_ycbv_stage1.
Writes <log_dir>/results_test_ycbv_stage2.json.
"""

from __future__ import annotations


def main(argv=None):
    from dcl_net_tpu_torch import resolve_device, strict_f32
    from dcl_net_tpu_torch.eval.evaluator import Stage2Evaluator
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.tools.common import (
        base_parser, build_model, build_ycbv_eval, init, load_model_weights,
        refuse_data_parallel, write_result_json,
    )
    from dcl_net_tpu_torch.tools.test_ycbv_stage1 import checkpoint_path

    parser = base_parser("DCL-Net YCBV stage-2 eval (PyTorch)")
    parser.add_argument("--iteration", default=2, type=int)
    parser.add_argument("--checkpoint_stage1", required=True)
    args = parser.parse_args(argv)
    refuse_data_parallel(args)
    logger, cfg = init(args, "test_ycbv_stage2")
    strict_f32()
    device = resolve_device(args.device)

    model = build_model(cfg, device=device)
    load_model_weights(model, args.checkpoint_stage1)
    refiner = Refiner(n_inp=int(cfg.model.n_inp), device=device)
    load_model_weights(refiner, checkpoint_path(args, cfg))
    dataset, loader = build_ycbv_eval(cfg)
    evaluator = Stage2Evaluator(model, refiner, dataset.model_points_array(),
                                iterations=args.iteration,
                                template_bank=dataset.template_bank(),
                                device=device, logger=logger)
    result = evaluator.evaluate(iter(loader))
    logger.warning(f"ADD-S AUC mean: {result['auc_mean']}  <2cm: {result['acc_mean']}")
    write_result_json(cfg, "test_ycbv_stage2", result)
    return result


if __name__ == "__main__":
    main()
