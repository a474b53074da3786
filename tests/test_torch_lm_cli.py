"""The port's LineMOD and Occlusion-LineMOD eval CLIs against the JAX
package's, and its stage-1 training on config_LM.yaml, on the on-disk
fixtures of tests/fixtures.py at the small shapes of tests/test_tools.py
(16^3 grid, 64 points): one random JAX model, saved as a JAX checkpoint for
the JAX CLIs and bridged into the port (weights.py) for the port's, which
run with --device cpu.

The fixture trees are shaped for the test: each LineMOD object's eval list
holds its frame twice (26 rows), object 04's SegNet label is empty (2 lost
rows, which LM skips), the Occlusion-LineMOD cat's mask is empty (1 lost
row, which LMO counts), and models_info.yml gives the objects diameters of
200-800 mm, so the thresholds (0.1 d) fall among the random model's
distances and the success rates are neither all 0 nor all 1.

Both CLIs run model.interp_mode=exact and one loader thread, so the
readers draw the same points from the same seeded global generator and the
evaluators score the same batches. The per-instance distances are held
within 1e-5 m; success is a step function of the distance, so the test
first checks that no distance lies within that tolerance of its threshold,
then holds the success rates, counts and n_scored equal.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from dcl_net_tpu.eval import evaluator as jax_evaluator
from dcl_net_tpu.tools.test_lm import main as jax_test_lm
from dcl_net_tpu.tools.test_lmo import main as jax_test_lmo
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.linemod import LM_OBJLIST, LMO_ID2NAME, LMO_OBJLIST
from dcl_net_tpu_torch.eval import evaluator as port_evaluator
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.tools.test_lm import main as port_test_lm
from dcl_net_tpu_torch.tools.test_lmo import main as port_test_lmo
from dcl_net_tpu_torch.tools.train_stage1 import main as train_stage1
from dcl_net_tpu_torch.train.checkpoints import to_reference_state_dict
from dcl_net_tpu_torch.weights import load_jax_variables
from tests import fixtures
from tests.test_torch_lm_data import blank_png
from tests.test_torch_ycbv_cli import random_jax_variables, save_both

torch.set_num_threads(2)

CONFIG = "configs/config_LM.yaml"
EXP = "DCL_Net_config_LM_id0"
SMALL = ["input_size=64", "tmp_size=64", "unit_voxel_extent=[0.024,0.024,0.024]",
         "voxel_num_limit=[16,16,16]"]
MODEL = ["model.n_inp=64", "model.n_tmp=64", "model.unit_voxel_extent=[0.024,0.024,0.024]",
         "model.voxel_num_limit=[16,16,16]", "model.interp_mode=exact"]
OVERRIDES = MODEL + [f"hyper_dataset_test.{s}" for s in SMALL] + [
    "hyper_dataloader_test.num_workers=1", "hyper_dataloader_test.bs=8"]
DIST_ATOL = 1e-5  # metres
LOST_LM, LOST_LMO = 4, "cat"
LM_ROWS, LMO_ROWS = 26, 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_cli")
    lm_root = fixtures.make_linemod_fixture(str(tmp))
    _, masks = fixtures.make_lmo_fixture(str(tmp), lm_root)
    for obj in LM_OBJLIST:
        with open(os.path.join(lm_root, "data", f"{obj:02d}", "test.txt"), "w") as f:
            f.write("0000\n0000\n")
    blank_png(os.path.join(lm_root, "segnet_results", f"{LOST_LM:02d}_label", "0000_label.png"))
    blank_png(os.path.join(masks, LOST_LMO, "0.png"))
    diameters = {obj: float(200 + 50 * i) for i, obj in enumerate(LM_OBJLIST)}
    with open(os.path.join(lm_root, "models", "models_info.yml"), "w") as f:
        yaml.safe_dump({obj: {"diameter": d} for obj, d in diameters.items()}, f)

    jax_log, port_log = str(tmp / "jax_log"), str(tmp / "port_log")
    cfg = Config.fromfile(CONFIG).apply_overrides(OVERRIDES)
    variables = random_jax_variables(OVERRIDES, CONFIG)
    save_both(variables, build_model(cfg, device="cpu"),
              os.path.join(jax_log, EXP), os.path.join(port_log, EXP))
    pth = str(tmp / "reference.pth")
    bridged = load_jax_variables(build_model(cfg, device="cpu"), variables)
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in to_reference_state_dict(bridged).items()}}, pth)
    common = ["--config", CONFIG, "--path_data", str(tmp), "--epoch", "1"]
    return {"jax": common + ["--log_root", jax_log],
            "port": common + ["--log_root", port_log, "--device", "cpu"],
            "port_log": port_log, "pth": pth, "path_data": str(tmp),
            "diameters": diameters}


def capture_scores(monkeypatch):
    """Record the (distances, class ids) each package's evaluator aggregates."""
    seen = {}
    for name, cls in (("jax", jax_evaluator.Evaluator), ("port", port_evaluator.Evaluator)):
        def hook(self, distances, class_ids, lost_per_class=None, _name=name,
                 _orig=cls.summarize):
            seen[_name] = (list(distances), list(class_ids))
            return _orig(self, distances, class_ids, lost_per_class)
        monkeypatch.setattr(cls, "summarize", hook)
    return seen


def assert_scores_match(got, want, seen, thresholds):
    (dj, cj), (dp, cp) = seen["jax"], seen["port"]
    assert cp == cj and len(dp) == len(dj) == got["n_scored"] == want["n_scored"]
    dj, dp = np.asarray(dj), np.asarray(dp)
    assert np.isfinite(dj).all() and (dj > 0).all()
    np.testing.assert_allclose(dp, dj, rtol=0, atol=DIST_ATOL)
    margin = np.abs(dj - np.asarray(thresholds)[np.asarray(cj)])
    assert margin.min() > DIST_ATOL, "a distance lies within the tolerance of its threshold"
    for key in ("success_per_class", "count_per_class", "success_mean"):
        assert got[key] == want[key], key
    assert 0.0 < got["success_mean"] < 1.0


def test_lm_cli_matches_jax(runs, monkeypatch):
    seen = capture_scores(monkeypatch)
    want = jax_test_lm(runs["jax"] + ["--override", *OVERRIDES])
    got = port_test_lm(runs["port"] + ["--override", *OVERRIDES])
    # LM skips the two lost rows of object 04
    assert (got["n_scored"], got["n_lost"]) == (LM_ROWS - 2, 2)
    counts = [0 if obj == LOST_LM else 2 for obj in LM_OBJLIST]
    assert got["count_per_class"] == counts
    thresholds = [runs["diameters"][obj] / 10000.0 for obj in LM_OBJLIST]
    assert_scores_match(got, want, seen, thresholds)
    with open(os.path.join(runs["port_log"], EXP, "results_test_lm.json")) as f:
        saved = json.load(f)
    assert saved["success_mean"] == got["success_mean"] and saved["n_scored"] == LM_ROWS - 2
    # a reference .pth of the same weights: the same scores, to the bit
    d_ckpt = seen["port"][0]
    got_pth = port_test_lm(runs["port"] + ["--checkpoint", runs["pth"], "--override", *OVERRIDES])
    assert seen["port"][0] == d_ckpt and got_pth == got


def test_lmo_cli_matches_jax(runs, monkeypatch):
    seen = capture_scores(monkeypatch)
    want = jax_test_lmo(runs["jax"] + ["--override", *OVERRIDES])
    got = port_test_lmo(runs["port"] + ["--override", *OVERRIDES])
    # LMO counts the cat's lost row in its denominator
    assert (got["n_scored"], got["n_lost"]) == (LMO_ROWS - 1, 1)
    assert got["count_per_class"] == [1] * 8
    cat = LMO_OBJLIST.index(next(k for k, v in LMO_ID2NAME.items() if v == LOST_LMO))
    assert got["success_per_class"][cat] == 0.0
    thresholds = [runs["diameters"][obj] / 10000.0 for obj in LMO_OBJLIST]
    assert_scores_match(got, want, seen, thresholds)
    with open(os.path.join(runs["port_log"], EXP, "results_test_lmo.json")) as f:
        assert json.load(f)["count_per_class"] == got["count_per_class"]


def test_lm_cli_batch_size_does_not_change_scores(runs, monkeypatch):
    """One batch of 64 holding all 26 rows and 38 fill rows scores as
    batches of 8 do."""
    seen = capture_scores(monkeypatch)
    small = port_test_lm(runs["port"] + ["--override", *OVERRIDES])
    d8 = seen["port"][0]
    big = port_test_lm(runs["port"] + ["--override", *OVERRIDES, "hyper_dataloader_test.bs=64"])
    np.testing.assert_allclose(seen["port"][0], d8, rtol=0, atol=DIST_ATOL)
    for key in ("success_per_class", "count_per_class", "n_scored", "n_lost"):
        assert big[key] == small[key], key


@pytest.mark.parametrize("extra", [[], ["train_template_bank=true"]])
def test_train_stage1_on_linemod(runs, tmp_path, extra):
    """One step at batch 8 of config_LM.yaml's LineMOD training reader (13
    fixture frames, occlusion augmentation, SE(3) draws): finite losses and
    a checkpoint; with the 13-object template bank too."""
    log_root = str(tmp_path / "log")
    train_stage1(["--config", CONFIG, "--path_data", runs["path_data"], "--log_root", log_root,
                  "--device", "cpu", "--override", *MODEL,
                  *[f"hyper_dataset_train.{s}" for s in SMALL],
                  "hyper_dataloader_train.bs=8", "hyper_dataloader_train.num_workers=1",
                  "max_epoch=1", "per_write=1", *extra])
    exp_dir = os.path.join(log_root, EXP)
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f.read().strip().splitlines()]
    for key in ("loss_all", "loss_pose", "grad_norm"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["skipped_nonfinite"] == 0.0
    state = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    assert state["step"] == 1
