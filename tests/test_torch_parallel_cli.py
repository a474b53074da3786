"""The port's CLIs over data-parallel ranks on the CPU (--device cpu
--n_devices 2: two spawned gloo ranks that meet through a file://
rendezvous), against the same CLI in one process, at the 16^3 test size:
stage-1 training (rank 0 alone logs and writes the checkpoint; the losses
are the single process's); tests/test_torch_parallel_eval_cli.py runs the
YCB-V stage-1 eval so. On the card path, --n_devices beyond the visible
GPUs raises before anything starts (the device count patched here)."""

import json
import os

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch.tools import (
    test_lm, test_lmo, test_ycbv_stage1, test_ycbv_stage2, train_stage1,
    train_ycbv_stage2,
)
from tests.test_torch_train_cli import CONFIG as TRAIN_CONFIG
from tests.test_torch_train_cli import EXP as TRAIN_EXP
from tests.test_torch_train_cli import SMALL_OVERRIDES

torch.set_num_threads(2)


def _records(exp_dir):
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f.read().strip().splitlines()]


def test_train_stage1_on_two_cpu_ranks_equals_one_process(tmp_path):
    runs = {}
    for n in (1, 2):
        log_root = str(tmp_path / f"log{n}")
        train_stage1.main(["--config", TRAIN_CONFIG, "--log_root", log_root,
                           "--device", "cpu", "--n_devices", str(n),
                           "--override", *SMALL_OVERRIDES])
        runs[n] = os.path.join(log_root, TRAIN_EXP)
    # rank 0 alone writes: one record a step (8 samples, global batch 4),
    # one checkpoint file, no other rank's leftovers
    records = _records(runs[2])
    assert len(records) == 2
    assert os.listdir(os.path.join(runs[2], "epoch_1")) == ["state.pt"]
    two = torch.load(os.path.join(runs[2], "epoch_1", "state.pt"), weights_only=True)
    one = torch.load(os.path.join(runs[1], "epoch_1", "state.pt"), weights_only=True)
    assert two["step"] == one["step"] == 2
    single = _records(runs[1])
    # step 1 from the same weights on the same global batch; step 2 after
    # an Adam step (eps 1e-6), which turns last-bit differences of small
    # gradient entries into steps of either sign (tests/test_multihost.py's
    # bounds)
    np.testing.assert_allclose(records[0]["loss_all"], single[0]["loss_all"], rtol=1e-5)
    np.testing.assert_allclose(records[1]["loss_all"], single[1]["loss_all"], rtol=5e-2)
    assert records[0]["skipped_nonfinite"] == 0.0


@pytest.mark.parametrize("tool", [train_stage1, train_ycbv_stage2, test_ycbv_stage1,
                                  test_ycbv_stage2, test_lm, test_lmo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_n_devices_beyond_the_visible_gpus_raises(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--config", TRAIN_CONFIG, "--log_root", str(tmp_path), "--n_devices", "2"]
    if tool in (train_ycbv_stage2, test_ycbv_stage2):
        argv += ["--checkpoint_stage1", str(tmp_path / "none")]
    with pytest.raises(ValueError, match="--n_devices 2: only 1 GPUs are visible"):
        tool.main(argv)
    assert not os.listdir(tmp_path)  # raised before any rank or run directory


def test_config_n_devices_starts_the_ranks_without_the_flag(tmp_path, monkeypatch):
    """parallel.n_devices stands for an absent --n_devices, as the JAX
    tools' build_mesh reads it (dcl_net_tpu/tools/common.py:126-140)."""
    started = []
    start = torch.multiprocessing.start_processes

    def counted(fn, args=(), nprocs=1, **kw):
        started.append(nprocs)
        return start(fn, args=args, nprocs=nprocs, **kw)

    monkeypatch.setattr(torch.multiprocessing, "start_processes", counted)
    log_root = str(tmp_path / "log")
    train_stage1.main(["--config", TRAIN_CONFIG, "--log_root", log_root, "--device", "cpu",
                       "--override", *SMALL_OVERRIDES, "parallel.n_devices=2"])
    assert started == [2]
    # rank 0 alone writes: one record a step of the global batch of 4
    records = _records(os.path.join(log_root, TRAIN_EXP))
    assert len(records) == 2 and records[0]["skipped_nonfinite"] == 0.0
    assert os.listdir(os.path.join(log_root, TRAIN_EXP, "epoch_1")) == ["state.pt"]
    # on the card path the config's count is held to the visible GPUs too
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="parallel.n_devices 2: only 1 GPUs are visible"):
        train_stage1.main(["--config", TRAIN_CONFIG, "--log_root", str(tmp_path / "gpu"),
                           "--override", "parallel.n_devices=2"])
