"""The port's stage-1 training CLI on the CPU at tiny shapes: it writes its
run directory and resumes from it, in f32 and in bf16 (whose checkpoint
then evaluates in either type), and trains with voxelization mode 2 and
interp_mode local, and refuses what it does not run (a worker type it
lacks)."""

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


@pytest.mark.parametrize("extra", ["model.voxelization_mode=2", "model.interp_mode=local"])
def test_train_stage1_takes_voxelization_modes_and_local(tmp_path, extra):
    log_root = str(tmp_path / "log")
    _run(log_root, extra)
    rec = _records(os.path.join(log_root, EXP))[-1]
    assert np.isfinite(rec["loss_all"])


@pytest.mark.parametrize("extra, match", [
    (["--override", "hyper_dataloader_train.worker_type=fiber"], "not ported"),
])
def test_train_stage1_refuses_what_is_not_ported(tmp_path, extra, match):
    args = ["--config", CONFIG, "--log_root", str(tmp_path), "--device", "cpu"]
    if extra[0] == "--override":
        args += ["--override", *SMALL_OVERRIDES, extra[1]]
    else:
        args += extra
    with pytest.raises(NotImplementedError, match=match):
        main(args)


def test_train_stage1_in_bf16_resumes_and_its_checkpoint_evaluates_in_both_types(tmp_path):
    """model.compute_dtype=bfloat16: the CLI trains through the bf16 path
    (K1-K3 forward, K4 and K5 backward on the card; their plain versions
    here), writes an f32 checkpoint and resumes from it, and the checkpoint
    loads into an f32 and a bf16 model, whose poses agree within bf16's
    drift."""
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.tools.common import build_model, load_model_weights

    log_root = str(tmp_path / "log")
    bf16 = ["model.compute_dtype=bfloat16", "model.interp_mode=pallas"]
    _run(log_root, *bf16)
    exp_dir = os.path.join(log_root, EXP)
    records = _records(exp_dir)
    assert len(records) == 2
    for rec in records:
        for key in ("loss_all", "grad_norm"):
            assert np.isfinite(rec[key]), key
        assert rec["skipped_nonfinite"] == 0.0
    state = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    assert {t.dtype for t in state["model"].values() if t.is_floating_point()} == {
        torch.float32}
    _run(log_root, *bf16, "max_epoch=2")
    assert torch.load(os.path.join(exp_dir, "epoch_2", "state.pt"),
                      weights_only=True)["step"] == 4

    cfg = Config.fromfile(CONFIG).apply_overrides(SMALL_OVERRIDES + ["model.interp_mode=pallas"])
    ds = SyntheticPoseDataset(n_points=64, unit_voxel_extent=(0.024,) * 3,
                              voxel_num_limit=(16, 16, 16), length=4, seed=3)
    batch = make_batch([ds[i] for i in range(4)]).to_dict()
    model_points = np.stack([ds.model_points(c, 32) for c in range(len(ds.cad_points))])
    poses = {}
    for name in ("float32", "bfloat16"):
        model = build_model(cfg.apply_overrides([f"model.compute_dtype={name}"]), device="cpu")
        load_model_weights(model, os.path.join(exp_dir, "epoch_2"))
        ev = Evaluator(model, model_points, device="cpu")
        res = ev._run(batch_to_torch(batch, "cpu"))
        assert np.isfinite(res["adds"].numpy()).all()
        poses[name] = res["rot_pred"]
    assert poses["float32"].dtype == poses["bfloat16"].dtype == torch.float32
    assert not torch.equal(poses["float32"], poses["bfloat16"])  # bf16 did run
    # bf16's rotation drift from f32 stays under a few degrees
    cos = ((poses["float32"] * poses["bfloat16"]).sum((1, 2)) - 1) / 2
    assert float(torch.rad2deg(torch.arccos(cos.clamp(-1, 1))).max()) < 5.0
