"""The port's evaluators on a bf16 stage 1 (model.compute_dtype: bfloat16)
against the JAX package's, on bridged weights: Evaluator (template cache in
bf16) and Stage2Evaluator (2 refinement steps; the refiner stays f32 and
the pose is carried in f32), the JAX stage 1 on its production bf16
variant (voxelize_impl="matmul", interp_mode="pallas", interpret mode).

The batches of tests/test_torch_eval.py (a lost row and a pad row), the
capacities of the JAX bf16 drift test (no level overflows, so the Pallas
compaction's aligned layout drops nothing). Poses are held to the JAX bf16
drift bound (rotation < 1 degree, translation < 0.5 mm) and ADD-S per
instance within 1 mm.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.eval.evaluator import Evaluator as JaxEvaluator
from dcl_net_tpu.eval.evaluator import Stage2Evaluator as JaxStage2Evaluator
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.weights import load_jax_variables
from tests.test_torch_bf16_model import CAPS, ROT_DEG, TRANS_MM, pose_drift
from tests.test_torch_eval import DS_KW, GRID, N, N_CLASSES, UNIT, _batches
from tests.test_torch_stage2 import ITERATIONS, _port_refiner, _refiner_variables

torch.set_num_threads(2)

KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS)
ADDS_ATOL = 1e-3  # metres


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticPoseDataset(**DS_KW)
    batches = _batches(ds)
    bank = ds.template_bank()
    model_points = np.stack([ds.model_points(c, 64) for c in range(N_CLASSES)])
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, dtype=jnp.bfloat16, interp_mode="pallas",
                       voxelize_impl="matmul", **KW)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, b: jmodel.init(k, b, train=False))(
            jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, batches[0])))
    tmodel = load_jax_variables(
        DCLNet(interp_mode="pallas", device="cpu", dtype=torch.bfloat16, **KW), variables)
    return batches, bank, model_points, jmodel, variables, tmodel


def _check_rows(got, want):
    rot, trans = pose_drift(np.asarray(want["rot_pred"]),
                            np.asarray(jnp.asarray(want["trans_pred"]).astype(jnp.float32)),
                            got["rot_pred"].double().numpy(), got["trans_pred"].double().numpy())
    assert rot.max() < ROT_DEG and trans.max() < TRANS_MM, (rot, trans)
    assert got["rot_pred"].dtype == got["trans_pred"].dtype == torch.float32
    np.testing.assert_allclose(got["adds"].numpy(), np.asarray(want["adds"]), rtol=0,
                               atol=ADDS_ATOL)
    np.testing.assert_array_equal(got["overflow"].numpy(), np.asarray(want["overflow"]))


def test_bf16_evaluator_matches_jax(setup):
    batches, bank, model_points, jmodel, variables, tmodel = setup
    jev = JaxEvaluator(jmodel, variables, model_points, protocol="adds_auc",
                       template_bank=bank)
    tev = Evaluator(tmodel, model_points, template_bank=bank, device="cpu")
    # the template cache holds the compute type: no f32 copy of it
    assert {v.dtype for k, v in tev._tmp_cache.items() if k in ("p1", "m1", "p2", "m2")} \
        == {torch.bfloat16}
    for batch in batches:
        got = tev._run(batch_to_torch(batch, "cpu"))
        _check_rows(got, jev._run(jev.variables, jax.tree.map(jnp.asarray, batch)))
    want, got = jev.evaluate(iter(batches)), tev.evaluate(iter(batches))
    assert got["n_scored"] == want["n_scored"] == 7  # 8 rows - 1 pad row
    assert got["n_lost"] == 1 and got["n_overflow"] == want["n_overflow"] == 0


def test_bf16_stage2_evaluator_matches_jax(setup):
    batches, bank, model_points, jmodel, variables, tmodel = setup
    jm, rvars = _refiner_variables(seed=4)
    jev = JaxStage2Evaluator(jmodel, variables, jm, rvars, model_points,
                             iterations=ITERATIONS, protocol="adds_auc", template_bank=bank)
    tev = Stage2Evaluator(tmodel, _port_refiner(rvars), model_points, iterations=ITERATIONS,
                          template_bank=bank, device="cpu")
    for batch in batches:
        got = tev._run(batch_to_torch(batch, "cpu"))
        _check_rows(got, jev._run(jev.variables, jax.tree.map(jnp.asarray, batch)))
    want, got = jev.evaluate(iter(batches)), tev.evaluate(iter(batches))
    assert got["n_scored"] == want["n_scored"] == 7
    assert got["n_overflow"] == want["n_overflow"] == 0
