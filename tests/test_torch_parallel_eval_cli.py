"""The port's YCB-V stage-1 eval CLI over two data-parallel gloo ranks on
the CPU (--device cpu --n_devices 2) against one process, on the fixture
tree of tests/fixtures.py at the 16^3 test size of
tests/test_torch_ycbv_cli.py: each rank scores its block of every global
batch and rank 0 writes the results file, equal to the single process's."""

import json
import os

import torch

from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.tools import test_ycbv_stage1
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.train.checkpoints import save_checkpoint
from dcl_net_tpu_torch.train.solver import TrainState
from tests import fixtures
from tests.test_torch_ycbv_cli import CONFIG as EVAL_CONFIG
from tests.test_torch_ycbv_cli import EXP as EVAL_EXP
from tests.test_torch_ycbv_cli import OVERRIDES as EVAL_OVERRIDES

torch.set_num_threads(2)


def test_ycbv_stage1_on_two_cpu_ranks_writes_the_single_process_results(tmp_path):
    """6 rows and a lost one at a global batch of 4: the second batch
    leaves rank 1 an empty block, which it fills with pad rows."""
    _, assets = fixtures.make_ycbv_fixture(str(tmp_path))
    cfg = Config.fromfile(EVAL_CONFIG).apply_overrides(EVAL_OVERRIDES)
    results = {}
    for n in (1, 2):
        log_root = str(tmp_path / f"log{n}")
        save_checkpoint(os.path.join(log_root, EVAL_EXP),
                        build_model(cfg, device="cpu", seed=4), TrainState({}), 1)
        got = test_ycbv_stage1.main([
            "--config", EVAL_CONFIG, "--path_data", os.path.dirname(assets),
            "--epoch", "1", "--log_root", log_root, "--device", "cpu",
            "--n_devices", str(n), "--override", *EVAL_OVERRIDES,
            "hyper_dataloader_test.bs=4"])
        with open(os.path.join(log_root, EVAL_EXP, "results_test_ycbv_stage1.json")) as f:
            results[n] = json.load(f)
        assert got["n_scored"] == results[n]["n_scored"] == 6
    assert results[2] == results[1]
    assert results[2]["n_lost"] == 1
