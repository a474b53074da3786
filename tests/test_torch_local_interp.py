"""interp_mode "local" of the port against the JAX package's.

- local_grid_interpolate (ops/grid_interp.py) against
  dcl_net_tpu/ops/grid_interp.py within 1e-6, at each level's scale, with
  points near and beyond the grid's faces, and in bf16 within one bf16
  rounding of JAX bf16;
- MultiScalePointFeatures(interp_mode="local") on a pyramid within 1e-5,
  its overflow flag False;
- a local DCLNet on bridged weights: eval poses within 1e-5 (the f32 pose
  tolerance of tests/test_torch_model.py); one train step's running
  statistics in f32 and its losses and gradient in f64 within the bounds of
  tests/test_torch_train_model.py, and its f32 losses within 1e-5 of the
  f64 ones, as JAX's f32 losses are; in bf16 on the inputs of
  tests/test_torch_bf16_model.py, the disengage outputs within its
  relative L2 bound and the poses within 1 degree and 0.5 mm of JAX bf16;
- the YCB-V stage-1 eval CLI with --override model.interp_mode=local on
  the fixture tree against the JAX CLI's scores, within the bounds of
  tests/test_torch_ycbv_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.data.schema import make_batch as jax_make_batch
from dcl_net_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu.models.backbone import MultiScalePointFeatures as JaxMSPF
from dcl_net_tpu.models.dcl_net import dcl_losses as jax_dcl_losses
from dcl_net_tpu.ops.grid_interp import local_grid_interpolate as jax_local
from dcl_net_tpu.tools.test_ycbv_stage1 import main as jax_main
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.models.backbone import MultiScalePointFeatures
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.ops.grid_interp import local_grid_interpolate
from dcl_net_tpu_torch.tools.test_ycbv_stage1 import main
from dcl_net_tpu_torch.weights import load_jax_variables
from tests.test_torch_bf16_model import FEAT_REL_L2, ROT_DEG, TRANS_MM, pose_drift, rel_l2
from tests.test_torch_train_model import (
    LOSSES, as_f64, assert_grads_close, assert_stats_close, build_setup, jax_step, torch_step,
)
from tests.test_torch_ycbv_cli import (  # noqa: F401  (runs: the CLI fixture)
    OVERRIDES, assert_scores_match, capture_distances, runs,
)

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = np.float32([0.024] * 3)
OFFSET = -0.5 * UNIT * np.float32(GRID)
KW = dict(unit_voxel_extent=tuple(UNIT), voxel_num_limit=GRID, capacities=(256, 64, 16, 8))
N = 128


def _level(rng, d, c, occupancy=0.25, dtype=np.float32):
    mask = (rng.rand(2, d, d, d) < occupancy).astype(np.float32)
    feats = (rng.randn(2, d, d, d, c) * mask[..., None]).astype(dtype)
    return feats, mask


def _points(rng, n=N):
    # most inside the volume, some beyond its faces (clipped cells)
    return ((rng.rand(2, n, 3) - 0.5) * 0.45).astype(np.float32)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_local_grid_interpolate_matches_jax(level):
    rng = np.random.RandomState(level)
    d, c, scale = (8, 4, 2, 1)[level], (32, 64, 128, 256)[level], (2, 4, 6, 8)[level]
    feats, mask = _level(rng, d, c, occupancy=0.3 if level < 2 else 0.6)
    pts = _points(rng)
    want = jax_local(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(mask), UNIT, scale,
                     OFFSET, 5)
    got = local_grid_interpolate(torch.from_numpy(pts), torch.from_numpy(feats),
                                 torch.from_numpy(mask), UNIT, scale, OFFSET, 5)
    assert got.dtype == torch.float32 and got.shape == (2, N, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [3, 5])
def test_local_grid_interpolate_bf16_and_window_match_jax(window):
    rng = np.random.RandomState(7)
    feats, mask = _level(rng, 8, 32)
    pts = _points(rng)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    want = jax_local(jnp.asarray(pts), jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16),
                     jnp.asarray(mask), UNIT, 2, OFFSET, window)
    got = local_grid_interpolate(torch.from_numpy(pts), fb, torch.from_numpy(mask), UNIT, 2,
                                 OFFSET, window)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    # one bf16 rounding of a sum JAX may take in another order
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7, atol=1e-6)
    f32 = local_grid_interpolate(torch.from_numpy(pts), torch.from_numpy(feats),
                                 torch.from_numpy(mask), UNIT, 2, OFFSET, window)
    w32 = jax_local(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(mask), UNIT, 2, OFFSET,
                    window)
    np.testing.assert_allclose(f32.numpy(), np.asarray(w32), rtol=1e-6, atol=1e-6)


def test_multiscale_point_features_local_matches_jax():
    rng = np.random.RandomState(3)
    pyramid = [_level(rng, d, c, occupancy=o)
               for d, c, o in ((8, 32, 0.3), (4, 64, 0.4), (2, 128, 0.6), (1, 256, 1.0))]
    pts = _points(rng)
    jm = JaxMSPF(unit_voxel_extent=tuple(UNIT), voxel_num_limit=GRID, interp_mode="local")
    want, wover = jm.apply({}, jnp.asarray(pts),
                           [(jnp.asarray(f), jnp.asarray(m)) for f, m in pyramid])
    tm = MultiScalePointFeatures(unit_voxel_extent=tuple(UNIT), voxel_num_limit=GRID,
                                 interp_mode="local")
    got, over = tm(torch.from_numpy(pts),
                   [(torch.from_numpy(f), torch.from_numpy(m)) for f, m in pyramid])
    assert got.shape == (2, N, 480)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not over.any() and not np.asarray(wover).any()


@pytest.fixture(scope="module")
def setup():
    return build_setup()


def test_local_model_eval_matches_jax(setup):
    _, variables, batch, _ = setup
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, interp_mode="local", **KW)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    tmodel = load_jax_variables(DCLNet(interp_mode="local", device="cpu", **KW), variables)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for key in ("rot_pred", "trans_pred", "conf", "Xo_pred", "Yc_pred"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    assert not got["overflow"].any()


def test_local_train_step_matches_jax(setup):
    _, variables, batch, _ = setup
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, interp_mode="local", **KW)

    def fwd(v, b):
        pred, mut = jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        return jax_dcl_losses(pred, b), mut["batch_stats"]

    want, want_stats = jax.jit(fwd)(variables, jax.tree.map(jnp.asarray, batch))
    got, _, got_stats = torch_step(variables, batch, torch.float32, interp_mode="local")
    assert_stats_close(got_stats, jax.tree.map(np.asarray, want_stats), 1e-5)
    # the gradient in f64 on both sides (tests/test_torch_train_model.py)
    v64, b64 = as_f64(variables), as_f64(batch)
    with jax.enable_x64(True):
        want64, want_grads, _ = jax_step(jmodel, v64, b64)
    got64, got_grads, _ = torch_step(v64, batch, torch.float64, interp_mode="local")
    for k in LOSSES:
        np.testing.assert_allclose(got64[k], float(want64[k]), rtol=1e-5, err_msg=k)
        # the f32 losses: this network's f32 loss_pose is ill-conditioned
        # (JAX f32 is 7.6e-6 from JAX f64 on it, the port 3.6e-6 the other
        # way), so each f32 side is held to the f64 value
        np.testing.assert_allclose(got[k], float(want64[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(want[k]), float(want64[k]), rtol=1e-5, err_msg=k)
    assert_grads_close(got_grads, want_grads, rel=1e-4)


def test_local_model_bf16_matches_jax_bf16():
    """On the inputs and PRNGKey(0) weights of tests/test_torch_bf16_model.py
    (JAX's bf16 drift test): the disengage outputs within its FEAT_REL_L2
    and the poses within its bound."""
    ds = JaxSynthetic(n_objects=2, n_points=N, unit_voxel_extent=tuple(UNIT),
                      voxel_num_limit=GRID, seed=5)
    batch = jax_make_batch([ds[i] for i in range(4)]).to_dict()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jm = JaxDCLNet(n_inp=N, n_tmp=N, interp_mode="local", dtype=jnp.bfloat16,
                   voxelize_impl="matmul", **KW)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(0), jbatch))

    def forward(v, b):
        obs = jm.apply(v, b, train=False, method=jm.encode_observed)
        return obs, jm.apply(v, b, train=False)

    want_obs, want = jax.jit(forward)(variables, jbatch)
    tmodel = load_jax_variables(
        DCLNet(interp_mode="local", dtype=torch.bfloat16, device="cpu", **KW), variables)
    tbatch = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        got_obs, got = tmodel.encode_observed(tbatch), tmodel(tbatch)
    assert got["F_Xo_p"].dtype == torch.bfloat16
    for head in ("p1", "m1", "p2", "m2"):
        assert rel_l2(want_obs[head], got_obs[head]) <= FEAT_REL_L2, head
    deg, mm = pose_drift(np.asarray(want["rot_pred"], np.float64),
                         np.asarray(want["trans_pred"].astype(jnp.float32), np.float64),
                         got["rot_pred"].double().numpy(), got["trans_pred"].double().numpy())
    assert deg.max() < ROT_DEG and mm.max() < TRANS_MM, (deg, mm)


def test_stage1_cli_local_matches_jax(runs, monkeypatch):  # noqa: F811
    seen = capture_distances(monkeypatch)
    over = ["--override", *OVERRIDES, "hyper_dataloader_test.bs=4", "model.interp_mode=local"]
    want = jax_main(runs["jax"] + over)
    got = main(runs["port"] + over)
    assert got["n_scored"] == 6 and got["n_lost"] == 1
    assert got["n_overflow"] == want["n_overflow"] == 0
    assert_scores_match(got, want, seen)
