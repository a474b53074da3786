"""The port's stage-2 training CLI on the CPU at tiny shapes: from a stage-1
checkpoint of the port it trains the refiner, writes its run directory with
the per_val probe score, resumes from it, also on a bf16 stage 1, and
on a stage 1 of voxelization mode 2 or interp_mode local."""

import json
import os

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.tools.train_ycbv_stage2 import main
from dcl_net_tpu_torch.train.checkpoints import save_checkpoint
from dcl_net_tpu_torch.train.solver import TrainState
from tests.test_torch_train_cli import CONFIG, EXP, SMALL_OVERRIDES

torch.set_num_threads(2)

# 4 samples in batches of 4 // iteration 2 = 2: two steps an epoch
OVERRIDES = SMALL_OVERRIDES + ["hyper_dataset_train.length=4"]


@pytest.fixture(scope="module")
def stage1_checkpoint(tmp_path_factory):
    """An epoch_<n> directory of the port's stage-1 trainer, on the fused
    path, with the CLI's config and overrides."""
    cfg = Config.fromfile(CONFIG).apply_overrides(
        OVERRIDES + ["model.interp_mode=pallas_fused"])
    model = build_model(cfg, device="cpu", seed=5)
    return save_checkpoint(str(tmp_path_factory.mktemp("stage1")), model,
                           TrainState(opt_state={}), epoch=1)


def _run(log_root, ckpt, *extra):
    main(["--config", CONFIG, "--log_root", log_root, "--device", "cpu",
          "--checkpoint_stage1", ckpt, "--iteration", "2",
          "--override", *OVERRIDES, *extra])


def _records(exp_dir, mode):
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        return [r for r in map(json.loads, f.read().strip().splitlines()) if r["mode"] == mode]


def test_train_stage2_writes_checkpoint_eval_and_resumes(tmp_path, stage1_checkpoint):
    log_root = str(tmp_path / "log")
    _run(log_root, stage1_checkpoint, "model.interp_mode=pallas_fused")
    exp_dir = os.path.join(log_root, EXP)
    state = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    assert state["step"] == 2
    assert set(k.split(".")[0] for k in state["model"]) == {
        "MLP_share", "regressor_rot2", "regressor_trans2"}  # the refiner's
    train = _records(exp_dir, "train")
    assert len(train) == 2
    for rec in train:
        for key in ("loss_all", "loss_last_iter", "grad_norm", "overflow_frac", "T_step"):
            assert np.isfinite(rec[key]), key
        assert rec["skipped_nonfinite"] == 0.0
    (ev,) = _records(exp_dir, "eval")  # per_val 1: after the epoch
    assert ev["step"] == 1 and np.isfinite(ev["refined_adds_mean"])
    # resume: epoch_1 is the newest checkpoint and max_epoch is 1
    _run(log_root, stage1_checkpoint, "model.interp_mode=pallas_fused")
    assert len(_records(exp_dir, "train")) == 2
    # one more epoch continues from the checkpoint's step and weights
    _run(log_root, stage1_checkpoint, "model.interp_mode=pallas_fused", "max_epoch=2")
    final = torch.load(os.path.join(exp_dir, "epoch_2", "state.pt"), weights_only=True)
    assert final["step"] == 4 and final["epoch"] == 2
    assert len(_records(exp_dir, "train")) == 4
    assert len(_records(exp_dir, "eval")) == 2


@pytest.mark.parametrize("extra", ["model.voxelization_mode=2", "model.interp_mode=local"])
def test_train_stage2_takes_voxelization_modes_and_local(tmp_path, stage1_checkpoint, extra):
    # the stage-1 checkpoint's weights do not depend on either key
    _run(str(tmp_path), stage1_checkpoint, extra)
    for rec in _records(os.path.join(str(tmp_path), EXP), "train"):
        assert np.isfinite(rec["loss_all"])


def test_train_stage2_reads_a_reference_pth(tmp_path, stage1_checkpoint):
    """Stage 1 from a reference .pth of the checkpoint's weights: the same
    losses step for step as from the checkpoint."""
    from tests.test_torch_ycbv_cli import save_reference_pth

    cfg = Config.fromfile(CONFIG).apply_overrides(OVERRIDES + ["model.interp_mode=pallas_fused"])
    model = build_model(cfg, device="cpu", seed=11)
    model.load_state_dict(torch.load(os.path.join(stage1_checkpoint, "state.pt"),
                                     weights_only=True)["model"])
    pth = save_reference_pth(model, str(tmp_path / "stage1.pth"))
    losses = []
    for name, ckpt in (("ckpt", stage1_checkpoint), ("pth", pth)):
        log_root = str(tmp_path / name)
        _run(log_root, ckpt, "model.interp_mode=pallas_fused")
        losses.append([r["loss_all"] for r in _records(os.path.join(log_root, EXP), "train")])
    assert len(losses[0]) == 2 and losses[1] == losses[0]


def test_train_stage2_on_a_bf16_stage1(tmp_path, stage1_checkpoint):
    """--override model.compute_dtype=bfloat16: stage 1 runs frozen in bf16
    (its f32 checkpoint loads into it), the refiner trains in f32, and the
    steps and the probe score are finite."""
    log_root = str(tmp_path / "log")
    _run(log_root, stage1_checkpoint, "model.interp_mode=pallas_fused",
         "model.compute_dtype=bfloat16")
    exp_dir = os.path.join(log_root, EXP)
    train = _records(exp_dir, "train")
    assert len(train) == 2
    for rec in train:
        for key in ("loss_all", "loss_last_iter", "grad_norm"):
            assert np.isfinite(rec[key]), key
        assert rec["skipped_nonfinite"] == 0.0
    (ev,) = _records(exp_dir, "eval")
    assert np.isfinite(ev["refined_adds_mean"])
    state = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    assert {t.dtype for t in state["model"].values()} == {torch.float32}
