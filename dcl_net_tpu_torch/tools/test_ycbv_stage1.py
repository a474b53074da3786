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

Data parallelism (--n_devices, --coordinator, torchrun; tools/common.py):
bs is the global batch, each rank scores its block of every batch (the
last one filled with pad rows), the ranks gather their scores, and rank 0
writes the results file, equal to one process's.
"""

from __future__ import annotations

import os


def checkpoint_path(args, cfg) -> str:
    return args.checkpoint or os.path.join(cfg.log_dir, f"epoch_{cfg.get('test_epoch', 0)}")


def main(argv=None):
    from dcl_net_tpu_torch.tools.common import base_parser, run_tool

    args = base_parser("DCL-Net YCBV stage-1 eval (PyTorch)").parse_args(argv)
    return run_tool(args, argv, main, _evaluate)


def _evaluate(args, group, device):
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.tools.common import (
        build_model, build_ycbv_eval, init, load_model_weights, write_result_json,
    )

    logger, cfg = init(args, "test_ycbv_stage1", group)
    strict_f32()

    model = build_model(cfg, device=device)
    load_model_weights(model, checkpoint_path(args, cfg))
    dataset, loader = build_ycbv_eval(cfg, device=device, logger=logger, group=group)
    evaluator = Evaluator(model, dataset.model_points_array(),
                          template_bank=dataset.template_bank(), device=device,
                          logger=logger, group=group)
    try:
        result = evaluator.evaluate(iter(loader))
    finally:
        loader.close()  # a process pool's workers
    logger.warning(f"ADD-S AUC mean: {result['auc_mean']}  <2cm: {result['acc_mean']}")
    write_result_json(cfg, "test_ycbv_stage1", result, group)
    return result


if __name__ == "__main__":
    main()
