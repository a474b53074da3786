"""The port's data-parallel serving artifact (serving.py with world=N).

The counterpart of the JAX package's mesh-sharded artifact
(tests/test_serving.py::test_export_sharded_mesh_matches_single_device):
stage-1 and stage-2 artifacts exported for a world of 2 ranks at a global
batch of 4, loaded over 2 spawned gloo ranks (tests/parallel_ranks.py),
each rank called with the whole request: every rank returns the whole
batch's outputs, in order, within 1e-5 of the one-process artifact's.
Export refuses a batch the world does not divide and a polymorphic batch
with a world above 1; load refuses an artifact on a world of another
size, either way. Model: configs/config_synthetic_smoke.yaml at the 16^3
overrides of tests/test_torch_export_cli.py, seeded weights.
"""

import tempfile

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch import serving
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.models.refiner import Refiner
from dcl_net_tpu_torch.ops.voxelize import point_to_voxel_index
from dcl_net_tpu_torch.parallel.mesh import Group
from dcl_net_tpu_torch.tools import export as export_tool
from dcl_net_tpu_torch.tools.common import build_model
from tests import parallel_ranks as pr
from tests.test_torch_export_cli import CONFIG, OVERRIDES

torch.set_num_threads(2)

BATCH = 4


def request(n=BATCH, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 64, 3).astype(np.float32) - 0.5) * 0.15
    feats = np.concatenate([np.ones((n, 64, 1), np.float32),
                            rng.rand(n, 64, 3).astype(np.float32) - 0.5, pts], -1)
    vi = point_to_voxel_index(torch.from_numpy(pts), (0.024,) * 3, (16,) * 3)
    return (torch.from_numpy(feats), vi,
            torch.tensor([0, 1, 1, 0, 1, 0][:n], dtype=torch.int32))


@pytest.fixture(scope="module")
def setup():
    cfg = Config.fromfile(CONFIG).apply_overrides(OVERRIDES)
    model = build_model(cfg, device="cpu")
    refiner = Refiner(n_inp=64, device="cpu", seed=1)
    bank = export_tool._bank_dataset(cfg).template_bank()
    return model, refiner, bank


@pytest.fixture(scope="module")
def sharded_stage1(setup):
    model, _, bank = setup
    return serving.export_serve(model, bank, BATCH, 64, world=2)


def test_sharded_artifacts_serve_equal_to_one_process_over_two_ranks(setup, sharded_stage1):
    model, refiner, bank = setup
    single = [serving.export_serve(model, bank, BATCH, 64),
              serving.export_serve_stage2(model, refiner, bank, BATCH, iterations=1)]
    sharded = [sharded_stage1,
               serving.export_serve_stage2(model, refiner, bank, BATCH, iterations=1, world=2)]
    req = request()
    with tempfile.TemporaryDirectory() as tmp:
        context = pr.start_ranks(tmp, {"sharded": sharded, "single": single[0],
                                       "request": req}, ["serve_mesh"])
        with torch.inference_mode():
            want = [serving.load_serve(data)(*req) for data in single]
        ranks = pr.finish_ranks(context, tmp)
    rows_bf16 = torch.cat([(torch.arange(3, dtype=torch.float32) / 3 + r).to(torch.bfloat16)
                           for r in range(2)])
    rows_bool = torch.tensor([True, True, False, False, True, False])
    for r, res in enumerate(ranks):
        res = res["serve_mesh"]
        assert res["refused_single"], r
        # the row gather keeps rank order, type and value
        assert torch.equal(res["gathered"]["bf16"], rows_bf16), r
        assert torch.equal(res["gathered"]["bool"], rows_bool), r
        for got, ref in zip(res["outputs"], want):
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
                np.testing.assert_allclose(got[k].float().numpy(), ref[k].float().numpy(),
                                           rtol=0, atol=1e-5, err_msg=f"rank {r}: {k}")
    # the artifact records its world and global batch; its program runs
    # BATCH / 2 rows
    program, meta = serving._load(sharded[0])
    assert meta == {"world": 2, "batch": BATCH}
    assert program.module()(*(x[:2] for x in req))["rot_pred"].shape == (2, 3, 3)


def test_sharded_export_and_load_refuse_what_does_not_fit(setup, sharded_stage1):
    model, refiner, bank = setup
    with pytest.raises(ValueError, match="not divisible"):
        serving.export_serve(model, bank, 3, 64, world=2)
    with pytest.raises(ValueError, match="not divisible"):
        serving.export_serve_stage2(model, refiner, bank, 5, world=2)
    with pytest.raises(ValueError, match="polymorphic"):
        serving.export_serve(model, bank, None, 64, world=2)
    with pytest.raises(ValueError, match="polymorphic"):
        serving.export_serve_stage2(model, refiner, bank, None, world=2)
    with pytest.raises(ValueError, match="world"):
        serving.export_serve(model, bank, 4, 64, world=0)
    with pytest.raises(ValueError, match="world of 2 ranks; it is loaded on 1"):
        serving.load_serve(sharded_stage1)


def test_a_group_moves_the_artifact_to_its_device(sharded_stage1):
    # exported on the CPU, loaded by a rank whose device is another (meta
    # here: the CPU has no second device): the weights, the template cache
    # and every device the graph names follow the group; the program as
    # exported refuses inputs on that device
    group = Group(rank=1, world=2, device=torch.device("meta"), backend="gloo")
    served = serving.load_serve(sharded_stage1, group=group)
    assert isinstance(served, serving.ShardedServe) and served.group is group
    state = list(served.module.parameters()) + list(served.module.buffers())
    assert state and all(t.device.type == "meta" for t in state)
    block = [x[2:].to("meta") for x in request()]
    out = served.module(*block)
    assert out["rot_pred"].shape == (2, 3, 3) and out["rot_pred"].device.type == "meta"
    assert out["overflow"].dtype == torch.bool and out["overflow"].device.type == "meta"
    program, _ = serving._load(sharded_stage1)
    with pytest.raises(RuntimeError):
        program.module()(*block)
