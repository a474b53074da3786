"""Occlusion-LineMOD eval CLI of the port (reference tools/test_LMO.py):
ADD(-S) < 0.1 d, lost detections counted in the denominator.

Usage:
  python -m dcl_net_tpu_torch.tools.test_lmo --config configs/config_LM.yaml \
      --path_data ./datasets --epoch 350

Counterpart of dcl_net_tpu/tools/test_lmo.py. Reads
<path_data>/OCCLUSION_LINEMOD with the HybridPose masks of
<path_data>/LMO_Masks and LineMOD's meshes and models_info.yml under
<path_data>/Linemod_preprocessed/models (data/linemod.py::
OcclusionLineMODDataset), and scores as tools/test_lm.py does, except that
a lost detection (empty mask) counts as a failure of its object. Writes
<log_dir>/results_test_lmo.json.
"""

from __future__ import annotations


def main(argv=None):
    import os

    from dcl_net_tpu_torch.data.linemod import LMO_SYM_IDX, OcclusionLineMODDataset
    from dcl_net_tpu_torch.tools.common import lm_root
    from dcl_net_tpu_torch.tools.test_lm import run_add_eval

    def make_dataset(cfg):
        return OcclusionLineMODDataset(
            "eval", cfg.hyper_dataset_test, os.path.join(cfg.path_data, "OCCLUSION_LINEMOD"),
            os.path.join(lm_root(cfg), "models"),
            masks_dir=os.path.join(cfg.path_data, "LMO_Masks"))

    def diameters(cfg, dataset):
        return dataset.diameters(os.path.join(lm_root(cfg), "models", "models_info.yml"))

    return run_add_eval(argv, "test_lmo", "DCL-Net Occlusion-LineMOD eval (PyTorch)",
                        make_dataset, diameters, LMO_SYM_IDX, count_lost=True)


if __name__ == "__main__":
    main()
