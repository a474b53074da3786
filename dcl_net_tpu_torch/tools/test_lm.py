"""LineMOD eval CLI of the port (reference tools/test_LM.py): ADD(-S) < 0.1 d.

Usage:
  python -m dcl_net_tpu_torch.tools.test_lm --config configs/config_LM.yaml \
      --path_data ./datasets --epoch 350
  python -m dcl_net_tpu_torch.tools.test_lm --config configs/config_LM.yaml \
      --path_data ./datasets --checkpoint <reference>.pth

Counterpart of dcl_net_tpu/tools/test_lm.py. Reads the eval split of
<path_data>/Linemod_preprocessed with the SegNet masks
(data/linemod.py::LineMODDataset "eval") in padded batches of
hyper_dataloader_test.bs, loads the weights from --checkpoint or
<log_dir>/epoch_<test_epoch> (a checkpoint directory of the port or a
reference .pth), encodes each object's template once, and scores each
instance by ADD, or ADD-S for eggbox and glue, against 0.1 x its diameter;
a lost detection (empty SegNet mask) is skipped. Writes
<log_dir>/results_test_lm.json. model.interp_mode picks the point-feature
path: the config's two-stage path (K2 -> centers -> K3), or pallas_fused
(K2 -> K6). hyper_dataset_test.device_preprocess runs the reader's numpy
tail on the device (data/device_preprocess.py), with LM eval's volume filter
whenever any candidate survives it (keep-clamp threshold 0, reference
LM/dataloader_test_LM.py:195-204). Data parallelism as in
tools/test_ycbv_stage1.py.
"""

from __future__ import annotations


def main(argv=None):
    from dcl_net_tpu_torch.data.linemod import LM_SYM_IDX, LineMODDataset
    from dcl_net_tpu_torch.tools.common import lm_root

    return run_add_eval(argv, main, "test_lm", "DCL-Net LineMOD eval (PyTorch)",
                        lambda cfg: LineMODDataset("eval", cfg.hyper_dataset_test,
                                                   lm_root(cfg)),
                        lambda cfg, ds: ds.diameters(), LM_SYM_IDX, count_lost=False,
                        keep_clamp=dict(eval_keep_clamp=True, keep_clamp_threshold=0))


def run_add_eval(argv, main, tool_name: str, description: str, make_dataset, diameters,
                 sym_class_ids, count_lost: bool, keep_clamp: dict):
    """The add_0.1d eval CLI: config, model and weights, the dataset
    make_dataset(cfg) in a BatchLoader (keep_clamp: the device
    preprocessing's eval keep-clamp, build_device_preprocess's arguments),
    Evaluator with diameters(cfg, dataset), the results file
    <log_dir>/results_<tool_name>.json; run by tools/common.py::run_tool,
    so over data-parallel ranks too (main: the tool's entry point, which
    its local ranks run)."""
    from dcl_net_tpu_torch.tools.common import base_parser, run_tool

    def evaluate(args, group, device):
        from dcl_net_tpu_torch import strict_f32
        from dcl_net_tpu_torch.eval.evaluator import Evaluator
        from dcl_net_tpu_torch.tools.common import (
            build_instance_eval_loader, build_model, init, load_model_weights,
            write_result_json,
        )
        from dcl_net_tpu_torch.tools.test_ycbv_stage1 import checkpoint_path

        logger, cfg = init(args, tool_name, group)
        strict_f32()
        model = build_model(cfg, device=device)
        dataset = make_dataset(cfg)
        load_model_weights(model, checkpoint_path(args, cfg))
        loader = build_instance_eval_loader(cfg, dataset, device=device, logger=logger,
                                            group=group, **keep_clamp)
        evaluator = Evaluator(model, dataset.model_points_array(), protocol="add_0.1d",
                              sym_class_ids=sym_class_ids,
                              diameters=diameters(cfg, dataset), count_lost=count_lost,
                              template_bank=dataset.template_bank(), device=device,
                              logger=logger, group=group)
        try:
            result = evaluator.evaluate(iter(loader))
        finally:
            loader.close()  # a process pool's workers
        logger.warning(f"mean success rate: {result['success_mean']}")
        write_result_json(cfg, tool_name, result, group)
        return result

    args = base_parser(description).parse_args(argv)
    return run_tool(args, argv, main, evaluate)


if __name__ == "__main__":
    main()
