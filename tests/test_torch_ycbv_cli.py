"""The port's YCB-V stage-1 eval CLI against the JAX package's, on the
on-disk fixture of tests/fixtures.py (3 classes, 2 frames, 6 instances, one
lost detection) at the small shapes of tests/test_tools.py (16^3 grid, 64
points, batches of 4), with one random JAX model: saved as a JAX checkpoint
for the JAX CLI, and bridged into the port (weights.py) and saved as a port
checkpoint for the port's CLI, which runs with --device cpu.

Both CLIs run model.interp_mode=exact and one loader thread, so the
readers draw the same points from the same seeded global generator, and
the evaluators score the same batches. The per-instance ADD-S distances are
held within 1e-5 m; the AUCs within 0.2, the bound tests/test_tools.py
uses, because the VOCap staircase turns a 1e-6 change of one of 6
distances into a step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.config import Config as JaxConfig
from dcl_net_tpu.data.schema import make_batch as jax_make_batch
from dcl_net_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from dcl_net_tpu.eval import evaluator as jax_evaluator
from dcl_net_tpu.tools.common import build_model as jax_build_model
from dcl_net_tpu.tools.test_ycbv_stage1 import main as jax_main
from dcl_net_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from dcl_net_tpu.train.solver import TrainState as JaxTrainState
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.eval import evaluator as port_evaluator
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.tools.test_ycbv_stage1 import main
from dcl_net_tpu_torch.train.checkpoints import save_checkpoint, to_reference_state_dict
from dcl_net_tpu_torch.train.solver import TrainState
from dcl_net_tpu_torch.weights import load_jax_variables
from tests import fixtures

torch.set_num_threads(2)

CONFIG = "configs/config_YCBV_bs32.yaml"
EXP = "DCL_Net_config_YCBV_bs32_id0"
OVERRIDES = [
    "model.n_inp=64", "model.n_tmp=64",
    "model.unit_voxel_extent=[0.024,0.024,0.024]",
    "model.voxel_num_limit=[16,16,16]", "model.interp_mode=exact",
    "hyper_dataset_test.input_size=64", "hyper_dataset_test.tmp_size=64",
    "hyper_dataset_test.unit_voxel_extent=[0.024,0.024,0.024]",
    "hyper_dataset_test.voxel_num_limit=[16,16,16]",
    "hyper_dataloader_test.num_workers=1",
]
AUC_ATOL = 0.2
ADDS_ATOL = 1e-5  # metres


def random_jax_variables(overrides, config=CONFIG):
    """A JAX DCLNet of the config, initialised at random as
    tests/test_tools.py does."""
    cfg = JaxConfig.fromfile(config).apply_overrides(overrides)
    model = jax_build_model(cfg)
    ds = JaxSynthetic(n_objects=2, n_points=64, unit_voxel_extent=(0.024,) * 3,
                      voxel_num_limit=(16,) * 3, length=4)
    batch = jax_make_batch([ds[i] for i in range(2)]).to_dict()
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), batch, train=True)
    return jax.tree.map(np.asarray, variables)


def save_both(variables, port_model, jax_dir, port_dir):
    """The weights as epoch_1 in jax_dir (a JAX checkpoint) and, bridged
    into port_model, in port_dir (a checkpoint of the port); returns the
    two checkpoint directories."""
    os.makedirs(jax_dir, exist_ok=True)
    jax_ckpt = jax_save_checkpoint(jax_dir, JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}), opt_state={}), 1)
    port_model = load_jax_variables(port_model, variables)
    return jax_ckpt, save_checkpoint(port_dir, port_model, TrainState(opt_state={}), epoch=1)


def capture_distances(monkeypatch):
    """Record the (distances, class ids) each package's evaluator scores."""
    seen = {}
    jax_summarize = jax_evaluator.Evaluator.summarize
    port_summarize = port_evaluator.per_class_auc_acc

    def jax_hook(self, distances, class_ids, lost_per_class=None):
        seen["jax"] = (list(distances), list(class_ids))
        return jax_summarize(self, distances, class_ids, lost_per_class)

    def port_hook(distances, class_ids, **kw):
        seen["port"] = (list(distances), list(class_ids))
        return port_summarize(distances, class_ids, **kw)

    monkeypatch.setattr(jax_evaluator.Evaluator, "summarize", jax_hook)
    monkeypatch.setattr(port_evaluator, "per_class_auc_acc", port_hook)
    return seen


def assert_scores_match(got, want, seen):
    """Equal instance counts and lost rows, ADD-S per instance within
    ADDS_ATOL, AUC and accuracy within AUC_ATOL."""
    (dj, cj), (dp, cp) = seen["jax"], seen["port"]
    assert got["n_scored"] == want["n_scored"] == len(dj) == len(dp)
    assert cp == cj
    dj, dp = np.asarray(dj), np.asarray(dp)
    lost = np.isinf(dj)
    np.testing.assert_array_equal(np.isinf(dp), lost)
    assert got["n_lost"] == int(lost.sum())
    assert np.isfinite(dj[~lost]).all() and (dj[~lost] > 0).all()
    np.testing.assert_allclose(dp[~lost], dj[~lost], rtol=0, atol=ADDS_ATOL)
    assert abs(got["auc_mean"] - want["auc_mean"]) < AUC_ATOL
    assert abs(got["acc_mean"] - want["acc_mean"]) < AUC_ATOL
    np.testing.assert_allclose(got["auc_per_class"], want["auc_per_class"], atol=AUC_ATOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ycbv_cli")
    _, assets = fixtures.make_ycbv_fixture(str(tmp))
    jax_log, port_log = str(tmp / "jax_log"), str(tmp / "port_log")
    cfg = Config.fromfile(CONFIG).apply_overrides(OVERRIDES)
    save_both(random_jax_variables(OVERRIDES), build_model(cfg, device="cpu"),
              os.path.join(jax_log, EXP), os.path.join(port_log, EXP))
    common = ["--config", CONFIG, "--path_data", os.path.dirname(assets), "--epoch", "1"]
    return {"jax": common + ["--log_root", jax_log],
            "port": common + ["--log_root", port_log, "--device", "cpu"],
            "port_log": port_log}


def test_stage1_cli_matches_jax(runs, monkeypatch):
    seen = capture_distances(monkeypatch)
    bs4 = ["--override", *OVERRIDES, "hyper_dataloader_test.bs=4"]
    want = jax_main(runs["jax"] + bs4)
    got = main(runs["port"] + bs4)
    assert got["n_scored"] == 6 and got["n_lost"] == 1
    assert got["n_overflow"] == want["n_overflow"] == 0
    assert_scores_match(got, want, seen)
    with open(os.path.join(runs["port_log"], EXP, "results_test_ycbv_stage1.json")) as f:
        saved = json.load(f)
    assert saved["auc_mean"] == got["auc_mean"] and saved["n_scored"] == 6
    # one batch of 128 holds all 6 rows and 122 fill rows: the same scores
    big = main(runs["port"] + ["--override", *OVERRIDES, "hyper_dataloader_test.bs=128"])
    assert (big["n_scored"], big["n_lost"]) == (6, 1)
    assert abs(big["auc_mean"] - got["auc_mean"]) < AUC_ATOL
    np.testing.assert_allclose(big["auc_per_class"], got["auc_per_class"], atol=AUC_ATOL)


@pytest.mark.parametrize("extra, match", [
    (["--override", *OVERRIDES, "model.remat=true"], "not ported"),
    (["--n_devices", "2"], "data parallelism"),
    (["--override", *OVERRIDES, "hyper_dataset_test.device_preprocess=true"], "not ported"),
    (["--override", *OVERRIDES, "hyper_dataloader_test.worker_type=process"], "thread"),
])
def test_stage1_cli_refuses_what_is_not_ported(runs, extra, match):
    # a reference .pth is taken: test_stage1_cli_reads_a_reference_pth
    with pytest.raises(NotImplementedError, match=match):
        main(runs["port"] + extra)


def save_reference_pth(model, path: str) -> str:
    """The port model's weights as a reference-layout .pth."""
    torch.save({"model_state_dict": {k: torch.from_numpy(np.asarray(v))
                                     for k, v in to_reference_state_dict(model).items()}},
               path)
    return path


def test_stage1_cli_reads_a_reference_pth(runs, tmp_path, monkeypatch):
    """The port checkpoint's weights written as a reference .pth score the
    same distances, to the bit."""
    cfg = Config.fromfile(CONFIG).apply_overrides(OVERRIDES)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(runs["port_log"], EXP, "epoch_1", "state.pt"),
                                     weights_only=True)["model"])
    pth = save_reference_pth(model, str(tmp_path / "stage1.pth"))
    seen = capture_distances(monkeypatch)
    bs4 = ["--override", *OVERRIDES, "hyper_dataloader_test.bs=4"]
    got = main(runs["port"] + bs4)
    from_ckpt = seen["port"]
    got_pth = main(runs["port"] + ["--checkpoint", pth] + bs4)
    assert seen["port"] == from_ckpt and got_pth == got
