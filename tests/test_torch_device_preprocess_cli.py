"""The port's CLIs on the device-preprocessing path, on the CPU at the 16^3
test shapes, on the fixture trees of tests/fixtures.py.

train_stage1 runs configs/config_YCBV_bs128_throughput.yaml as written
(device_preprocess, samples_per_frame 2, process workers, the template
bank) and configs/config_YCBV_bs256_peak.yaml with model.remat (process
workers on the numpy path), cut to 16^3 and batches of 4.

test_ycbv_stage1 (keep-clamp 32), test_lm (keep-clamp 0) and test_lmo (no
clamp, min_points 0) on the device path are held to the same CLI on the
numpy path with the draws forced equal: both resample the kept candidates
in candidate order (np.random.choice and device_preprocess._draw_cand_idx
replaced by that deterministic draw), so the model sees the same rows and
points. The batches the evaluator scores agree row for row: flags, classes
and rotations exactly, points, features and translations within INPUT_ATOL,
voxel indices within one. INPUT_ATOL is the numpy path's own rounding: it
takes the centroid of a few thousand f32 points as a sequential f32 sum
(numpy reduces along axis 0 row by row), off by up to 5e-5 m on these
trees, where torch sums as a tree. Random weights turn that shift into
distance changes of up to 0.6 mm, so the scores are held by their counts
and lost rows exactly and by the mean AUC or success rate within
SCORE_ATOL, the bound of the other CLI tests.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data import device_preprocess as dp
from dcl_net_tpu_torch.data.linemod import LM_OBJLIST
from dcl_net_tpu_torch.eval import evaluator as port_evaluator
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.tools.test_lm import main as lm_main
from dcl_net_tpu_torch.tools.test_lmo import main as lmo_main
from dcl_net_tpu_torch.tools.test_ycbv_stage1 import main as ycbv_stage1_main
from dcl_net_tpu_torch.tools.train_stage1 import main as train_stage1
from dcl_net_tpu_torch.train.checkpoints import save_checkpoint
from dcl_net_tpu_torch.train.solver import TrainState
from tests import fixtures
from tests.test_torch_lm_data import blank_png

torch.set_num_threads(2)

SMALL = ["input_size=64", "tmp_size=64", "unit_voxel_extent=[0.024,0.024,0.024]",
         "voxel_num_limit=[16,16,16]"]
MODEL = ["model.n_inp=64", "model.n_tmp=64", "model.unit_voxel_extent=[0.024,0.024,0.024]",
         "model.voxel_num_limit=[16,16,16]", "model.capacities=[256,64,16,8]"]
INPUT_ATOL = 1e-4  # metres
SCORE_ATOL = 0.2
DEVICE_PATH = ["hyper_dataset_test.device_preprocess=True"]


def first_kept_choice(a, size=None, replace=True, p=None):
    """np.random.choice replaced: the first `size` of range(a), cyclically."""
    return np.arange(int(size)) % int(a)


def first_kept_draw(keep, n_points, generator):
    """_draw_cand_idx replaced: each row's kept candidates in candidate
    order, cyclically (what the numpy path takes under first_kept_choice)."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    count = keep.sum(dim=1, keepdim=True).clamp(min=1)
    return torch.gather(order, 1, torch.arange(n_points)[None, :] % count)


@pytest.fixture
def equal_draws(monkeypatch):
    monkeypatch.setattr(np.random, "choice", first_kept_choice)
    monkeypatch.setattr(dp, "_draw_cand_idx", first_kept_draw)


def capture(monkeypatch):
    """Per CLI run: the batches the port's evaluator scores (as numpy) and
    the distances it aggregates."""
    runs = []
    orig_run, orig_summarize = port_evaluator.Evaluator._run, port_evaluator.Evaluator.summarize

    def run(self, batch):
        if not runs or "distances" in runs[-1]:
            runs.append({"batches": []})
        runs[-1]["batches"].append({
            "feats": batch["inp"]["feats"].numpy(), "vidx": batch["inp"]["voxel_idx"].numpy(),
            "rot": batch["labels"]["rot_gt"].numpy(), "trans": batch["labels"]["trans_gt"].numpy(),
            "obj": batch["labels"]["obj_idx"].numpy(), "valid": batch["valid"].numpy(),
            "pad": batch["pad"].numpy()})
        return orig_run(self, batch)

    def summarize(self, distances, class_ids, lost_per_class=None):
        runs[-1]["distances"] = np.asarray(distances)
        return orig_summarize(self, distances, class_ids, lost_per_class)

    monkeypatch.setattr(port_evaluator.Evaluator, "_run", run)
    monkeypatch.setattr(port_evaluator.Evaluator, "summarize", summarize)
    return runs


def assert_same_scores(host, device, runs, score: str):
    for key in ("n_scored", "n_lost", "n_overflow"):
        assert host[key] == device[key], key
    assert abs(host[score] - device[score]) <= SCORE_ATOL
    h_run, d_run = runs
    assert len(h_run["batches"]) == len(d_run["batches"])
    for hb, db in zip(h_run["batches"], d_run["batches"]):
        for key in ("obj", "valid", "pad", "rot"):
            np.testing.assert_array_equal(db[key], hb[key], err_msg=key)
        real = (hb["valid"] > 0) & ~(hb["pad"] > 0)
        for key in ("feats", "trans"):
            np.testing.assert_allclose(db[key][real], hb[key][real], rtol=0, atol=INPUT_ATOL,
                                       err_msg=key)
        assert np.abs(db["vidx"][real].astype(np.int64) - hb["vidx"][real]).max() <= 1
    finite = np.isfinite(h_run["distances"])
    assert finite.sum() > 0
    np.testing.assert_array_equal(np.isfinite(d_run["distances"]), finite)


def port_checkpoint(config, overrides, log_dir):
    """A seeded port model of the config as <log_dir>/epoch_1."""
    model = build_model(Config.fromfile(config).apply_overrides(overrides), device="cpu")
    return save_checkpoint(log_dir, model, TrainState(opt_state={}), 1)


@pytest.fixture(scope="module")
def ycbv_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ycbv_dev")
    fixtures.make_ycbv_fixture(str(tmp), second_video=True)
    return str(tmp)


@pytest.mark.parametrize("config, extra", [
    ("configs/config_YCBV_bs128_throughput.yaml", []),
    ("configs/config_YCBV_bs256_peak.yaml", ["model.remat=true"]),
], ids=["bs128_throughput", "bs256_peak_remat"])
def test_train_stage1_runs_the_large_batch_configs(ycbv_tree, tmp_path, config, extra):
    """The configs' loaders as written (process workers; bs128: device
    preprocessing, 2 draws a frame, the bank), at 16^3 and batches of 4:
    one epoch of the fixture's 4 frames, finite, no step skipped."""
    cfg = Config.fromfile(config)
    spf = int(cfg.hyper_dataset_train.get("samples_per_frame", 1))
    assert cfg.hyper_dataloader_train.worker_type == "process" and cfg.train_template_bank
    overrides = MODEL + [f"hyper_dataset_train.{s}" for s in SMALL] + [
        "hyper_dataloader_train.bs=4", "hyper_dataloader_train.num_workers=2",
        "max_epoch=1", "per_write=1", *extra]
    log_root = tmp_path / "log"
    train_stage1(["--config", config, "--path_data", ycbv_tree, "--log_root", str(log_root),
                  "--device", "cpu", "--override", *overrides])
    (exp_dir,) = log_root.glob("*")
    records = [json.loads(line) for line in
               (exp_dir / "scalars.jsonl").read_text().strip().splitlines()]
    assert len(records) == 4 * spf // 4
    for rec in records:
        for key in ("loss_all", "grad_norm", "T_step", "T_data"):
            assert np.isfinite(rec[key]), key
        assert rec["skipped_nonfinite"] == 0.0
    state = torch.load(exp_dir / "epoch_1" / "state.pt", weights_only=True)
    assert state["step"] == len(records)


def test_ycbv_stage1_device_path_matches_the_numpy_path(ycbv_tree, tmp_path, monkeypatch,
                                                        equal_draws):
    config = "configs/config_YCBV_bs32.yaml"
    overrides = MODEL + [f"hyper_dataset_test.{s}" for s in SMALL] + [
        "hyper_dataloader_test.bs=4", "hyper_dataloader_test.num_workers=1"]
    ckpt = port_checkpoint(config, overrides, str(tmp_path / "ckpt"))
    args = ["--config", config, "--path_data", ycbv_tree, "--checkpoint", ckpt,
            "--device", "cpu", "--log_root", str(tmp_path / "log"), "--override", *overrides]
    runs = capture(monkeypatch)
    host = ycbv_stage1_main(args)
    device = ycbv_stage1_main(args + DEVICE_PATH + ["hyper_dataloader_test.worker_type=process",
                                                    "hyper_dataloader_test.num_workers=2"])
    assert (host["n_scored"], host["n_lost"]) == (12, 1)
    assert_same_scores(host, device, runs, "auc_mean")


@pytest.fixture(scope="module")
def lm_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_dev")
    lm_root = fixtures.make_linemod_fixture(str(tmp))
    _, masks = fixtures.make_lmo_fixture(str(tmp), lm_root)
    for obj in LM_OBJLIST:
        with open(os.path.join(lm_root, "data", f"{obj:02d}", "test.txt"), "w") as f:
            f.write("0000\n")
    blank_png(os.path.join(lm_root, "segnet_results", "04_label", "0000_label.png"))
    blank_png(os.path.join(masks, "cat", "0.png"))
    with open(os.path.join(lm_root, "models", "models_info.yml"), "w") as f:
        yaml.safe_dump({obj: {"diameter": 200.0 + 50 * i}
                        for i, obj in enumerate(LM_OBJLIST)}, f)
    return str(tmp)


@pytest.mark.parametrize("tool, lost_scored", [(lm_main, False), (lmo_main, True)],
                         ids=["test_lm", "test_lmo"])
def test_lm_device_path_matches_the_numpy_path(lm_tree, tmp_path, monkeypatch, equal_draws,
                                               tool, lost_scored):
    """13 LM rows (object 04's SegNet label empty: skipped) or 8 LMO rows
    (the cat's mask empty: counted as a failure)."""
    config = "configs/config_LM.yaml"
    overrides = MODEL + [f"hyper_dataset_test.{s}" for s in SMALL] + [
        "hyper_dataloader_test.bs=8", "hyper_dataloader_test.num_workers=1"]
    ckpt = port_checkpoint(config, overrides, str(tmp_path / "ckpt"))
    args = ["--config", config, "--path_data", lm_tree, "--checkpoint", ckpt,
            "--device", "cpu", "--log_root", str(tmp_path / "log"), "--override", *overrides]
    runs = capture(monkeypatch)
    host = tool(args)
    device = tool(args + DEVICE_PATH)
    assert (host["n_scored"], host["n_lost"]) == ((7, 1) if lost_scored else (12, 1))
    assert_same_scores(host, device, runs, "success_mean")
