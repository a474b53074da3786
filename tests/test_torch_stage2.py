"""The port's stage 2 (Refiner, refine_pose, refiner_losses,
Stage2Evaluator, make_stage2_train_step) against the JAX package's, on
the same numpy inputs and bridged weights.

The port's stage-1 model runs the fused path (interp_mode="pallas_fused",
plain versions on the CPU); the JAX stage-1 model runs its exact path, the
one golden-matched to the reference, which drops the same over-capacity
voxels. Small shapes: 16^3 grid, N = M = 128, the Refiner at its published
widths (259 -> 512 -> 512 -> 1024 and the two heads).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.config import Config as JaxConfig
from dcl_net_tpu.eval.evaluator import Stage2Evaluator as JaxStage2Evaluator
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu.models import refiner as jref
from dcl_net_tpu.train import solver as jsolver
from dcl_net_tpu.train.stage2 import make_stage2_train_step as jax_stage2_step
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.eval.evaluator import Stage2Evaluator
from dcl_net_tpu_torch.models import refiner as tref
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.train import solver as tsolver
from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step
from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_torch_eval import DS_KW, N_CLASSES, _batches
from tests.test_torch_eval import KW as EVAL_KW
from tests.test_torch_model import _assert_trees_equal
from tests.test_torch_train_model import GRID, KW, N, UNIT, build_setup, leaves
from tests.test_torch_train_solver import STEP_CFG

torch.set_num_threads(2)

ITERATIONS = 2
# STEP_CFG's chain (eps = 1: the update is close to linear in the
# gradient) at a learning rate that moves every refiner leaf well past the
# f32 noise of the comparison
STAGE2_CFG = dict(STEP_CFG, lr_scheduler_cyc={"max_lr": 1.0, "base_lr": 0.1,
                                              "step_size_up": 2, "step_size_down": 2})


def _rotations(rng, b):
    out = []
    for _ in range(b):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        out.append(q * np.sign(np.linalg.det(q)))
    return np.stack(out).astype(np.float32)


def _refiner_variables(seed=0, n=N):
    """A JAX Refiner's params with the Dense biases drawn away from zero."""
    jm = jref.Refiner(n_inp=n)
    dummy = {"input_features": jnp.zeros((1, n, 259)), "conf": jnp.zeros((1, 2 * n))}
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), dummy)["params"])
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if path[-1].key == "bias" else a, params)
    return jm, {"params": params}


def _refiner_inputs(rng, b=3, n=N):
    pts = ((rng.rand(b, n, 3) - 0.5) * 0.2).astype(np.float32)
    f_xo_p = rng.randn(b, n, 256).astype(np.float32)
    conf = rng.uniform(0.05, 0.95, (b, 2 * n)).astype(np.float32)
    return pts, f_xo_p, conf, _rotations(rng, b), (rng.randn(b, 3) * 0.02).astype(np.float32)


def _port_refiner(variables, n=N):
    return load_jax_variables(tref.Refiner(n_inp=n, device="cpu"), variables)


def test_refiner_forward_and_weight_round_trip_match_jax():
    jm, variables = _refiner_variables()
    tm = _port_refiner(variables)
    round_trip = to_jax_variables(tm)
    assert round_trip["batch_stats"] == {}
    _assert_trees_equal(round_trip["params"], variables["params"])  # bit-equal
    pts, f_xo_p, conf, _, _ = _refiner_inputs(np.random.RandomState(3))
    feats = np.concatenate([pts, f_xo_p], -1)
    want = jm.apply(variables, {"input_features": jnp.asarray(feats),
                                "conf": jnp.asarray(conf)})
    with torch.no_grad():
        got = tm({"input_features": torch.from_numpy(feats), "conf": torch.from_numpy(conf)})
    # f32 MLP sums in other orders, then the SVD of the ortho-9D output
    for key in ("rot_pred", "trans_pred"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_refine_pose_matches_jax():
    jm, variables = _refiner_variables(seed=2)
    tm = _port_refiner(variables)
    args = _refiner_inputs(np.random.RandomState(4))
    want = jref.refine_pose(jm.apply, variables, *map(jnp.asarray, args), ITERATIONS)
    with torch.no_grad():
        got = tref.refine_pose(tm, *map(torch.from_numpy, args), ITERATIONS)
    # two compositions, each an f32 bmm (JAX: HIGHEST), of f32 refiner outputs
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_refiner_losses_match_jax():
    rng = np.random.RandomState(5)
    b, p = 4, 64
    pred = {"rot_pred": _rotations(rng, b), "trans_pred": (rng.randn(b, 3) * 0.01).astype(np.float32)}
    args = [(rng.randn(b, 3) * 0.02).astype(np.float32), _rotations(rng, b),
            (rng.randn(b, p, 3) * 0.05).astype(np.float32),
            np.array([1.0, 0.0, 1.0, 0.0], np.float32), _rotations(rng, b),
            (rng.randn(b, 3) * 0.02).astype(np.float32)]
    valid = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    for v in (None, valid):
        want = jref.refiner_losses({k: jnp.asarray(a) for k, a in pred.items()},
                                   *map(jnp.asarray, args),
                                   None if v is None else jnp.asarray(v))
        got = tref.refiner_losses({k: torch.from_numpy(a) for k, a in pred.items()},
                                  *map(torch.from_numpy, args),
                                  None if v is None else torch.from_numpy(v))
        for key in ("loss_pose", "loss_all"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6,
                                       err_msg=key)


def test_stage2_evaluator_matches_jax():
    """Over-capacity samples, a lost row and a pad row, as in
    tests/test_torch_eval.py; the port's stage 1 on the fused path."""
    ds = SyntheticPoseDataset(**DS_KW)
    batches = _batches(ds)
    bank = ds.template_bank()
    model_points = np.stack([ds.model_points(c, 64) for c in range(N_CLASSES)])
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, **EVAL_KW)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, b: jmodel.init(k, b, train=False))(
            jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, batches[0])))
    jm, rvars = _refiner_variables(seed=4)
    jev = JaxStage2Evaluator(jmodel, variables, jm, rvars, model_points,
                             iterations=ITERATIONS, protocol="adds_auc",
                             template_bank=bank)
    tmodel = load_jax_variables(
        DCLNet(interp_mode="pallas_fused", device="cpu", **EVAL_KW), variables)
    tev = Stage2Evaluator(tmodel, _port_refiner(rvars), model_points,
                          iterations=ITERATIONS, template_bank=bank, device="cpu")
    for batch in batches:
        want = jev._run(jev.variables, jax.tree.map(jnp.asarray, batch))
        got = tev._run(batch_to_torch(batch, "cpu"))
        # per-instance ADD-S (m) of the refined pose, f32 through both stages
        np.testing.assert_allclose(got["adds"].numpy(), np.asarray(want["adds"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["overflow"].numpy(),
                                      np.asarray(want["overflow"]))
    want = jev.evaluate(iter(batches))
    got = tev.evaluate(iter(batches))
    assert got["n_scored"] == want["n_scored"] == 7  # 8 rows - 1 pad row
    assert got["n_overflow"] == want["n_overflow"] > 0
    assert got["auc_mean"] == want["auc_mean"]


def _stage2_setup():
    """JAX and port stage-1 models on the same weights, the refiner's
    variables, the batch of tests/test_torch_train_model.py and CAD clouds."""
    jmodel, variables, batch, _ = build_setup()
    ds = SyntheticPoseDataset(n_objects=2, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    cld = np.stack([ds.model_points(c, N) for c in range(2)]).astype(np.float32)
    jm, rvars = _refiner_variables(seed=6)
    tmodel = load_jax_variables(DCLNet(interp_mode="pallas_fused", device="cpu", **KW),
                                variables)
    return jmodel, variables, tmodel, batch, cld, jm, rvars


@pytest.fixture(scope="module")
def stage2_runs():
    """Three steps on each side from the same state: JAX's
    make_stage2_train_step (jitted) and the port's, with the optimizer
    chain built from the same config (STAGE2_CFG)."""
    jmodel, variables, tmodel, batch, cld, jm, rvars = _stage2_setup()
    tx, _ = jsolver.build_optimizer(JaxConfig(STAGE2_CFG), 1)
    jstep = jax.jit(jax_stage2_step(jmodel, variables, jm, tx, ITERATIONS, jnp.asarray(cld)))
    jstate = jsolver.TrainState(step=jnp.zeros((), jnp.int32), params=rvars["params"],
                                batch_stats={}, opt_state=tx.init(rvars["params"]))
    jb = jax.tree.map(jnp.asarray, batch)

    refiner = _port_refiner(rvars)
    opt, _ = tsolver.build_optimizer(Config(STAGE2_CFG), 1)
    tstep = make_stage2_train_step(tmodel, refiner, opt, ITERATIONS, torch.from_numpy(cld))
    tstate = tsolver.TrainState(opt.init(sum(p.numel() for p in refiner.parameters())))
    tb = batch_to_torch(batch, "cpu")
    stats = {k: v.clone() for k, v in tmodel.state_dict().items()}
    out = []
    for _ in range(3):
        jstate, jmetrics = jstep(jstate, jb)
        tmetrics = tstep(tstate, tb)
        out.append((jax.tree.map(np.asarray, jstate.params),
                    {k: float(v) for k, v in jmetrics.items()},
                    to_jax_variables(refiner)["params"],
                    {k: float(v) for k, v in tmetrics.items()}))
    return out, rvars["params"], tmodel, stats


@pytest.mark.parametrize("steps", [1, 3])
def test_stage2_train_steps_match_jax(stage2_runs, steps):
    runs, params0, tmodel, stats = stage2_runs
    want_params, want_metrics, got_params, got_metrics = runs[steps - 1]
    # f32 on both sides: stage-1 outputs within ~1e-5, the losses within
    # 1e-5 relative, and parameters within 1e-6 after 1 and 3 steps. Each
    # leaf's update moves it by at least 2e-5, twenty times that, and agrees
    # with JAX's update to 1e-3 of the leaf's largest change (the rest is
    # the rounding of the f32 parameters, a few 1e-9)
    for key in ("loss_all", "loss_last_iter", "grad_norm", "overflow_frac"):
        np.testing.assert_allclose(got_metrics[key], want_metrics[key], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert got_metrics["skipped_nonfinite"] == 0.0
    got, init = dict(leaves(got_params)), dict(leaves(params0))
    for path, w in leaves(want_params):
        name = "/".join(path)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-6, err_msg=name)
        dw, dg = w - init[path], got[path] - init[path]
        scale = np.abs(dw).max()
        assert scale >= 2e-5, f"{name}: the step moved it by {scale} only"
        np.testing.assert_allclose(dg, dw, rtol=0, atol=1e-3 * scale, err_msg=name)
    # the frozen stage 1 kept its weights and BN statistics, and eval mode
    assert not tmodel.training
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, stats[k]), k


def test_stage2_train_step_under_bf16_main_model():
    """The refiner (f32) trains on a frozen bf16 stage 1, the JAX package's
    production setting (tests/test_train.py::
    test_stage2_train_step_under_bf16_main_model): the stage-1 pose, bf16
    trans_pred included, is taken to f32 and composed in f32. One step of
    the port and of JAX's jitted step from the same bridged weights: the
    port's losses are within 2e-2 of JAX's (measured 1.8e-3: the bf16 stage
    1 takes its f32 sums in other orders), the refiner moved and stayed
    f32, and the stage 1 kept its state."""
    jmodel, variables, _, batch, cld, jm, rvars = _stage2_setup()
    jbf = JaxDCLNet(n_inp=N, n_tmp=N, dtype=jnp.bfloat16, interp_mode="pallas_fused",
                    voxelize_impl="matmul", **KW)
    tx, _ = jsolver.build_optimizer(JaxConfig(STAGE2_CFG), 1)
    jstep = jax.jit(jax_stage2_step(jbf, variables, jm, tx, ITERATIONS, jnp.asarray(cld)))
    jstate = jsolver.TrainState(step=jnp.zeros((), jnp.int32), params=rvars["params"],
                                batch_stats={}, opt_state=tx.init(rvars["params"]))
    _, want = jstep(jstate, jax.tree.map(jnp.asarray, batch))

    tmodel = load_jax_variables(DCLNet(interp_mode="pallas_fused", device="cpu",
                                       dtype=torch.bfloat16, **KW), variables)
    refiner = _port_refiner(rvars)
    opt, _ = tsolver.build_optimizer(Config(STAGE2_CFG), 1)
    step = make_stage2_train_step(tmodel, refiner, opt, ITERATIONS, torch.from_numpy(cld))
    state = tsolver.TrainState(opt.init(sum(p.numel() for p in refiner.parameters())))
    stats = {k: v.clone() for k, v in tmodel.state_dict().items()}
    before = [p.detach().clone() for p in refiner.parameters()]
    got = step(state, batch_to_torch(batch, "cpu"))
    assert float(got["skipped_nonfinite"]) == 0.0
    for key in ("loss_all", "loss_last_iter"):
        assert np.isfinite(float(got[key]))
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=2e-2, err_msg=key)
    assert {p.dtype for p in refiner.parameters()} == {torch.float32}
    assert all(not torch.equal(a, p) for a, p in zip(before, refiner.parameters()))
    assert not tmodel.training and tmodel.dtype == torch.bfloat16
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, stats[k]), k
