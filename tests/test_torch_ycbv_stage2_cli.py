"""The port's YCB-V stage-2 eval CLI against the JAX package's, and the
port's stage-2 trainer on YCB-V data, on the fixture of tests/fixtures.py
at the small shapes of tests/test_torch_ycbv_cli.py.

One random JAX stage-1 model and one JAX Refiner, saved as JAX checkpoints
for the JAX CLI and bridged into the port (weights.py) for the port's CLI;
both refine each pose twice (--iteration 2). The scores are held to the
stage-1 file's bounds: the same instances and lost rows, ADD-S per instance
within 1e-5 m, AUCs within 0.2. Then train_ycbv_stage2 takes one step on
hyper_dataset_train.name=ycbv_train, whose ADD-S loss reads the CAD clouds
of the YCB-V training reader.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.models import refiner as jax_refiner
from dcl_net_tpu.tools.test_ycbv_stage2 import main as jax_main
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.models.refiner import Refiner
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.tools.test_ycbv_stage2 import main
from dcl_net_tpu_torch.tools.train_ycbv_stage2 import main as train_main
from tests import fixtures
from tests.test_torch_ycbv_cli import (
    AUC_ATOL, OVERRIDES, assert_scores_match, capture_distances, random_jax_variables,
    save_both,
)

torch.set_num_threads(2)

CONFIG = "configs/config_YCBV_bs40.yaml"
EXP = "DCL_Net_config_YCBV_bs40_id0"
N = 64  # model.n_inp of OVERRIDES
TRAIN_OVERRIDES = [
    "hyper_dataset_train.input_size=64", "hyper_dataset_train.tmp_size=64",
    "hyper_dataset_train.unit_voxel_extent=[0.024,0.024,0.024]",
    "hyper_dataset_train.voxel_num_limit=[16,16,16]",
    "hyper_dataloader_train.bs=4", "hyper_dataloader_train.num_workers=1",
    "max_epoch=1", "per_write=1", "per_val=1",
]


def random_jax_refiner(seed=1):
    """A JAX Refiner's params at random, the Dense biases away from zero."""
    jm = jax_refiner.Refiner(n_inp=N)
    dummy = {"input_features": jnp.zeros((1, N, 259)), "conf": jnp.zeros((1, 2 * N))}
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), dummy)["params"])
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if path[-1].key == "bias" else a, params)
    return {"params": params}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ycbv_stage2")
    _, assets = fixtures.make_ycbv_fixture(str(tmp))
    cfg = Config.fromfile(CONFIG).apply_overrides(OVERRIDES)
    stage1 = save_both(random_jax_variables(OVERRIDES, CONFIG),
                       build_model(cfg, device="cpu"),
                       str(tmp / "jax_stage1"), str(tmp / "port_stage1"))
    refiner = save_both(random_jax_refiner(), Refiner(n_inp=N, device="cpu"),
                        str(tmp / "jax_refiner"), str(tmp / "port_refiner"))
    common = ["--config", CONFIG, "--path_data", os.path.dirname(assets),
              "--iteration", "2"]
    return {
        "jax": common + ["--log_root", str(tmp / "jax_log"),
                         "--checkpoint_stage1", stage1[0], "--checkpoint", refiner[0]],
        "port": common + ["--log_root", str(tmp / "port_log"), "--device", "cpu",
                          "--checkpoint_stage1", stage1[1], "--checkpoint", refiner[1]],
        "port_log": str(tmp / "port_log"),
        "path_data": os.path.dirname(assets),
        "port_stage1": stage1[1],
    }


def test_stage2_cli_matches_jax(setup, monkeypatch):
    seen = capture_distances(monkeypatch)
    bs4 = ["--override", *OVERRIDES, "hyper_dataloader_test.bs=4"]
    want = jax_main(setup["jax"] + bs4)
    got = main(setup["port"] + bs4)
    assert (got["n_scored"], got["n_lost"]) == (6, 1)
    assert_scores_match(got, want, seen)
    with open(os.path.join(setup["port_log"], EXP, "results_test_ycbv_stage2.json")) as f:
        assert json.load(f)["auc_mean"] == got["auc_mean"]
    big = main(setup["port"] + ["--override", *OVERRIDES, "hyper_dataloader_test.bs=128"])
    assert (big["n_scored"], big["n_lost"]) == (6, 1)
    assert abs(big["auc_mean"] - got["auc_mean"]) < AUC_ATOL


def test_stage2_cli_refuses_a_reference_checkpoint(setup):
    with pytest.raises(NotImplementedError, match="not ported"):
        main(setup["port"] + ["--checkpoint", "refiner.pth"])


def test_train_stage2_on_ycbv(setup, tmp_path):
    """One epoch of one step (2 fixture frames in batches of 4 // 2) on the
    YCB-V training reader, from the port's stage-1 checkpoint."""
    log_root = str(tmp_path / "log")
    train_main(["--config", CONFIG, "--log_root", log_root, "--device", "cpu",
                "--path_data", setup["path_data"], "--iteration", "2",
                "--checkpoint_stage1", setup["port_stage1"],
                "--override", *OVERRIDES, *TRAIN_OVERRIDES])
    exp_dir = os.path.join(log_root, EXP)
    state = torch.load(os.path.join(exp_dir, "epoch_1", "state.pt"), weights_only=True)
    assert state["step"] == 1
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f.read().strip().splitlines()]
    (train,) = [r for r in records if r["mode"] == "train"]
    (ev,) = [r for r in records if r["mode"] == "eval"]
    assert np.isfinite(train["loss_all"]) and train["skipped_nonfinite"] == 0.0
    assert np.isfinite(ev["refined_adds_mean"])
