"""The port's stage-1 training CLI on the CPU at tiny shapes: it writes its
run directory and resumes from it, and refuses what it does not run yet."""

import json
import os

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch.tools.train_stage1 import main

torch.set_num_threads(2)

CONFIG = "configs/config_synthetic_smoke.yaml"
EXP = "DCL_Net_config_synthetic_smoke_id0"
# the overrides of tests/test_tools.py: 16^3 grid, 64 points, batches of 4
SMALL_OVERRIDES = [
    "model.n_inp=64", "model.n_tmp=64",
    "model.unit_voxel_extent=[0.024,0.024,0.024]",
    "model.voxel_num_limit=[16,16,16]",
    "hyper_dataset_train.input_size=64", "hyper_dataset_train.tmp_size=64",
    "hyper_dataset_train.unit_voxel_extent=[0.024,0.024,0.024]",
    "hyper_dataset_train.voxel_num_limit=[16,16,16]",
    "hyper_dataset_train.length=8",
    "hyper_dataloader_train.bs=4", "hyper_dataloader_train.num_workers=2",
    "max_epoch=1", "per_write=1",
]


def _run(log_root, *extra):
    main(["--config", CONFIG, "--log_root", log_root, "--device", "cpu",
          "--override", *SMALL_OVERRIDES, *extra])


def _records(exp_dir):
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f.read().strip().splitlines()]


def test_train_stage1_writes_checkpoint_and_resumes(tmp_path):
    log_root = str(tmp_path / "log")
    _run(log_root)
    exp_dir = os.path.join(log_root, EXP)
    assert os.path.isfile(os.path.join(exp_dir, "epoch_1", "state.pt"))
    records = _records(exp_dir)
    assert len(records) == 2  # 8 samples in batches of 4, per_write 1
    for rec in records:
        assert rec["mode"] == "train"
        for key in ("loss_all", "grad_norm", "T_step", "T_data", "lr"):
            assert np.isfinite(rec[key]), key
        assert rec["skipped_nonfinite"] == 0.0
    assert os.path.isdir(os.path.join(exp_dir, "source_backup", "dcl_net_tpu_torch"))
    before = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    # resume: epoch_1 is the newest checkpoint and max_epoch is 1, so the
    # second call trains nothing and leaves it as it was
    _run(log_root)
    assert len(_records(exp_dir)) == 2
    after = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    assert after["step"] == before["step"] == 2
    # one more epoch continues from the checkpoint's step and weights
    _run(log_root, "max_epoch=2")
    final = torch.load(os.path.join(exp_dir, "epoch_2", "state.pt"), weights_only=True)
    assert final["step"] == 4 and final["epoch"] == 2
    assert len(_records(exp_dir)) == 4
    assert _records(exp_dir)[-1]["step"] == 4


def test_train_stage1_template_bank_option(tmp_path):
    log_root = str(tmp_path / "log")
    _run(log_root, "train_template_bank=true")
    rec = _records(os.path.join(log_root, EXP))[-1]
    assert np.isfinite(rec["loss_all"])


@pytest.mark.parametrize("extra, match", [
    (["--n_devices", "2"], "data parallelism"),
    (["--override", "model.compute_dtype=bfloat16"], "f32 only"),
    (["--override", "model.interp_mode=local"], "not ported"),
])
def test_train_stage1_refuses_what_is_not_ported(tmp_path, extra, match):
    args = ["--config", CONFIG, "--log_root", str(tmp_path), "--device", "cpu"]
    if extra[0] == "--override":
        args += ["--override", *SMALL_OVERRIDES, extra[1]]
    else:
        args += extra
    with pytest.raises(NotImplementedError, match=match):
        main(args)
