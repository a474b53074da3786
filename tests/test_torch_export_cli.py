"""The port's export CLI (dcl_net_tpu_torch/tools/export.py) on the CPU.

configs/config_synthetic_smoke.yaml with --device cpu and the 16^3
overrides of the JAX package's CLI tests (tests/test_serving.py): a
stage-1 artifact (also on interp_mode local), a stage-2 artifact and a
bundle, each loaded again and
served on a small synthetic request (finite poses, the output keys), as
cases of one test. The artifact of seeded weights equals the direct serve
of the same seeded model. With --n_devices 2 the CLI exports the
data-parallel artifact, which two ranks serve equal to one process.
"""

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch import serving
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.ops.voxelize import point_to_voxel_index
from dcl_net_tpu_torch.tools import export as export_tool
from dcl_net_tpu_torch.tools.common import build_model

torch.set_num_threads(2)

CONFIG = "configs/config_synthetic_smoke.yaml"
OVERRIDES = [
    "model.n_inp=64", "model.n_tmp=64",
    "model.voxel_num_limit=[16,16,16]",
    "model.unit_voxel_extent=[0.024,0.024,0.024]",
    "model.capacities=[256,64,16,8]",
    "hyper_dataset_train.input_size=64",
    "hyper_dataset_train.tmp_size=64",
    "hyper_dataset_train.voxel_num_limit=[16,16,16]",
    "hyper_dataset_train.unit_voxel_extent=[0.024,0.024,0.024]",
]


def _request(n=3):
    rng = np.random.RandomState(0)
    pts = (rng.rand(n, 64, 3).astype(np.float32) - 0.5) * 0.15
    feats = np.concatenate([np.ones((n, 64, 1), np.float32),
                            rng.rand(n, 64, 3).astype(np.float32) - 0.5, pts], -1)
    vi = point_to_voxel_index(torch.from_numpy(pts), (0.024,) * 3, (16,) * 3)
    return torch.from_numpy(feats), vi, torch.tensor([0, 1, 0], dtype=torch.int32)[:n]


@pytest.mark.parametrize("kind", ["stage1", "stage2", "bundle", "stage1_local"])
def test_export_cli(tmp_path, kind):
    out = str(tmp_path / ("bundle" if kind == "bundle" else "smoke.pt2"))
    argv = ["--config", CONFIG, "--device", "cpu", "--log_root", str(tmp_path / "log")]
    if kind == "bundle":
        argv += ["--bundle", out, "--bundle_batches", "2"]
    else:
        argv += ["--out", out, "--batch", "3"]
    if kind == "stage2":
        argv += ["--stage2", "--iteration", "1"]
    overrides = OVERRIDES + (["model.interp_mode=local"] if kind == "stage1_local" else [])
    path = export_tool.main(argv + ["--override", *overrides])
    assert path == out
    request = _request()
    if kind == "bundle":
        server = serving.BundleServer(path)
        assert server.fixed_sizes == [2] and server.has_poly
        got = server(*request)  # one padded chunk of 2 after one of 2
    else:
        got = serving.load_serve(path)(*request)
    keys = {"rot_pred", "trans_pred", "conf", "overflow"}
    assert set(got) == (keys | {"rot_stage1", "trans_stage1"} if kind == "stage2" else keys)
    assert got["rot_pred"].shape == (3, 3, 3)
    assert torch.isfinite(got["rot_pred"]).all() and torch.isfinite(got["trans_pred"]).all()
    if kind.startswith("stage1"):
        # the CLI's seeded weights and bank give the direct serve's poses
        cfg = Config.fromfile(CONFIG).apply_overrides(overrides)
        model = build_model(cfg, device="cpu")
        bank = export_tool._bank_dataset(cfg).template_bank()
        direct = serving.make_serve_fn(model, serving.encode_template_cache(model, bank))
        with torch.no_grad():
            want = direct(*request)
        for k in keys:
            assert torch.equal(got[k], want[k]), k


def test_export_cli_n_devices_2_exports_and_serves_equal_to_one_process(tmp_path):
    """--n_devices 2 --device cpu: two spawned gloo ranks export the
    data-parallel artifact (rank 0 writes it), which two ranks then serve,
    each with the whole request, equal to the one-process artifact within
    1e-5 (tests/test_torch_serving_mesh.py); a batch that 2 does not divide
    raises."""
    import tempfile

    from tests import parallel_ranks as pr

    argv = ["--config", CONFIG, "--device", "cpu", "--log_root", str(tmp_path / "log"),
            "--batch", "4"]
    sharded = export_tool.main(argv + ["--n_devices", "2", "--out", str(tmp_path / "dp.pt2"),
                                       "--override", *OVERRIDES])
    single = export_tool.main(argv + ["--out", str(tmp_path / "one.pt2"),
                                      "--override", *OVERRIDES])
    feats, vi, _ = _request(3)
    req = (torch.cat([feats, feats[:1]]), torch.cat([vi, vi[:1]]),
           torch.tensor([0, 1, 0, 1], dtype=torch.int32))
    with open(sharded, "rb") as f:
        data = f.read()
    with open(single, "rb") as f:
        one = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        context = pr.start_ranks(tmp, {"sharded": [data], "single": one, "request": req},
                                 ["serve_mesh"])
        with torch.inference_mode():
            want = serving.load_serve(one)(*req)
        ranks = pr.finish_ranks(context, tmp)
    for res in ranks:
        got = res["serve_mesh"]["outputs"][0]
        for k in want:
            np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
    with pytest.raises(Exception, match="not divisible"):
        export_tool.main(argv[:-1] + ["3", "--n_devices", "2", "--out",
                                      str(tmp_path / "bad.pt2"), "--override", *OVERRIDES])
