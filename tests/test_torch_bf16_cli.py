"""The port's eval CLIs under --override model.compute_dtype=bfloat16
model.interp_mode=pallas against the JAX package's with the same overrides
plus model.voxelize_impl=matmul (its production bf16 variant, the Pallas
kernels in interpret mode), on the CPU fixtures of tests/fixtures.py at the
16^3 overrides of tests/test_torch_ycbv_cli.py, one random JAX model
bridged into the port.

Both sides take 128 points a cloud: the JAX model takes its Pallas
interpolation only where N % 128 == 0 (dcl_net_tpu/models/backbone.py:123),
and at 64 points it would run its exact path instead. Scored and lost rows
and n_overflow are held equal, the distances per instance within 1 mm (the
bf16 pose drift bound is 1 degree and 0.5 mm).
"""

import os

import numpy as np
import pytest
import torch

from dcl_net_tpu.tools.test_lm import main as jax_test_lm
from dcl_net_tpu.tools.test_ycbv_stage1 import main as jax_test_ycbv
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.tools.test_lm import main as port_test_lm
from dcl_net_tpu_torch.tools.test_ycbv_stage1 import main as port_test_ycbv
from tests import fixtures
from tests.test_torch_lm_cli import capture_scores
from tests.test_torch_ycbv_cli import random_jax_variables, save_both

torch.set_num_threads(2)

DIST_ATOL = 1e-3  # metres
SMALL = ["input_size=128", "tmp_size=128", "unit_voxel_extent=[0.024,0.024,0.024]",
         "voxel_num_limit=[16,16,16]"]
MODEL = ["model.n_inp=128", "model.n_tmp=128",
         "model.unit_voxel_extent=[0.024,0.024,0.024]", "model.voxel_num_limit=[16,16,16]",
         "model.interp_mode=pallas", "model.compute_dtype=bfloat16"]
OVERRIDES = MODEL + [f"hyper_dataset_test.{s}" for s in SMALL] + [
    "hyper_dataloader_test.num_workers=1", "hyper_dataloader_test.bs=4"]
JAX_ONLY = ["model.voxelize_impl=matmul"]
CLIS = {  # config, experiment, the JAX and the port CLI, the tree writer
    "ycbv": ("configs/config_YCBV_bs32.yaml", "DCL_Net_config_YCBV_bs32_id0",
             jax_test_ycbv, port_test_ycbv),
    "lm": ("configs/config_LM.yaml", "DCL_Net_config_LM_id0", jax_test_lm, port_test_lm),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16_cli")
    _, assets = fixtures.make_ycbv_fixture(str(tmp / "ycbv"))
    fixtures.make_linemod_fixture(str(tmp / "lm"))
    paths = {"ycbv": os.path.dirname(assets), "lm": str(tmp / "lm")}
    out = {}
    for name, (config, exp, _, _) in CLIS.items():
        cfg = Config.fromfile(config).apply_overrides(OVERRIDES)
        jax_log, port_log = str(tmp / f"{name}_jax"), str(tmp / f"{name}_port")
        port_model = build_model(cfg, device="cpu")
        assert port_model.dtype == torch.bfloat16
        save_both(random_jax_variables(OVERRIDES + JAX_ONLY, config), port_model,
                  os.path.join(jax_log, exp), os.path.join(port_log, exp))
        common = ["--config", config, "--path_data", paths[name], "--epoch", "1"]
        out[name] = (common + ["--log_root", jax_log],
                     common + ["--log_root", port_log, "--device", "cpu"])
    return out


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_bf16_cli_matches_jax_bf16(trees, cli, monkeypatch):
    seen = capture_scores(monkeypatch)
    _, _, jax_main, port_main = CLIS[cli]
    jax_args, port_args = trees[cli]
    want = jax_main(jax_args + ["--override", *OVERRIDES, *JAX_ONLY])
    got = port_main(port_args + ["--override", *OVERRIDES])
    (dj, cj), (dp, cp) = seen["jax"], seen["port"]
    assert cp == cj and got["n_scored"] == want["n_scored"] == len(dp) == len(dj) > 0
    assert got["n_lost"] == want.get("n_lost", got["n_lost"])
    assert got["n_overflow"] == want["n_overflow"]
    dj, dp = np.asarray(dj), np.asarray(dp)
    lost = np.isinf(dj)
    np.testing.assert_array_equal(np.isinf(dp), lost)
    assert np.isfinite(dj[~lost]).all()
    np.testing.assert_allclose(dp[~lost], dj[~lost], rtol=0, atol=DIST_ATOL)
