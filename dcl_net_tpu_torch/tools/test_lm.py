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
(K2 -> K6).
"""

from __future__ import annotations


def main(argv=None):
    from dcl_net_tpu_torch.data.linemod import LM_SYM_IDX, LineMODDataset
    from dcl_net_tpu_torch.tools.common import lm_root

    return run_add_eval(argv, "test_lm", "DCL-Net LineMOD eval (PyTorch)",
                        lambda cfg: LineMODDataset("eval", cfg.hyper_dataset_test,
                                                   lm_root(cfg)),
                        lambda cfg, ds: ds.diameters(), LM_SYM_IDX, count_lost=False)


def run_add_eval(argv, tool_name: str, description: str, make_dataset, diameters,
                 sym_class_ids, count_lost: bool):
    """The add_0.1d eval CLI: config, model and weights, the dataset
    make_dataset(cfg) in a BatchLoader, Evaluator with diameters(cfg,
    dataset), the results file <log_dir>/results_<tool_name>.json."""
    from dcl_net_tpu_torch import resolve_device, strict_f32
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.tools.common import (
        base_parser, build_instance_eval_loader, build_model, init,
        load_model_weights, refuse_data_parallel, write_result_json,
    )
    from dcl_net_tpu_torch.tools.test_ycbv_stage1 import checkpoint_path

    args = base_parser(description).parse_args(argv)
    refuse_data_parallel(args)
    logger, cfg = init(args, tool_name)
    strict_f32()
    device = resolve_device(args.device)

    model = build_model(cfg, device=device)
    dataset = make_dataset(cfg)
    load_model_weights(model, checkpoint_path(args, cfg))
    loader = build_instance_eval_loader(cfg, dataset)
    evaluator = Evaluator(model, dataset.model_points_array(), protocol="add_0.1d",
                          sym_class_ids=sym_class_ids,
                          diameters=diameters(cfg, dataset), count_lost=count_lost,
                          template_bank=dataset.template_bank(), device=device,
                          logger=logger)
    result = evaluator.evaluate(iter(loader))
    logger.warning(f"mean success rate: {result['success_mean']}")
    write_result_json(cfg, tool_name, result)
    return result


if __name__ == "__main__":
    main()
