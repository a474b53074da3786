"""YCB-Video stage-1 eval CLI of the port (reference tools/test_YCBV_stage1.py).

Usage:
  python -m dcl_net_tpu_torch.tools.test_ycbv_stage1 \
      --config configs/config_YCBV_bs32.yaml --path_data ./datasets --epoch 84

Counterpart of dcl_net_tpu/tools/test_ycbv_stage1.py. Reads the test split
under <path_data>/YCB_Video_Dataset (data/ycbv.py::YCBVTestDataset, frames
in padded batches of hyper_dataloader_test.bs), loads the weights from
--checkpoint or <log_dir>/epoch_<test_epoch>, a checkpoint directory of the
port or a reference .pth, encodes each class's template once, scores every
ground-truth instance by ADD-S (a lost detection scores inf), logs the mean
AUC and <2 cm accuracy, and writes <log_dir>/results_test_ycbv_stage1.json.
model.interp_mode picks the point-feature path (default two-stage).
hyper_dataset_test.device_preprocess runs the readers' numpy tail on the
device (data/device_preprocess.py) with the test loader's keep-clamp at 32.
"""

from __future__ import annotations

import os


def checkpoint_path(args, cfg) -> str:
    return args.checkpoint or os.path.join(cfg.log_dir, f"epoch_{cfg.get('test_epoch', 0)}")


def main(argv=None):
    from dcl_net_tpu_torch import resolve_device, strict_f32
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.tools.common import (
        base_parser, build_model, build_ycbv_eval, init, load_model_weights,
        refuse_data_parallel, write_result_json,
    )

    args = base_parser("DCL-Net YCBV stage-1 eval (PyTorch)").parse_args(argv)
    refuse_data_parallel(args)
    logger, cfg = init(args, "test_ycbv_stage1")
    strict_f32()
    device = resolve_device(args.device)

    model = build_model(cfg, device=device)
    load_model_weights(model, checkpoint_path(args, cfg))
    dataset, loader = build_ycbv_eval(cfg, device=device, logger=logger)
    evaluator = Evaluator(model, dataset.model_points_array(),
                          template_bank=dataset.template_bank(), device=device,
                          logger=logger)
    try:
        result = evaluator.evaluate(iter(loader))
    finally:
        loader.close()  # a process pool's workers
    logger.warning(f"ADD-S AUC mean: {result['auc_mean']}  <2cm: {result['acc_mean']}")
    write_result_json(cfg, "test_ycbv_stage1", result)
    return result


if __name__ == "__main__":
    main()
