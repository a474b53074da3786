"""Voxelization modes 0-2 and point_recover of the port against the JAX package.

dcl_net_tpu_torch/ops/voxelize.py against dcl_net_tpu/ops/voxelize.py on
the same numpy-seeded inputs, bit-equal: mode 0 (unique: a sum over
voxels of at most one point each), 1 (first) and 2 (last), with and
without a point mask, and point_recover. voxelize_cuda on CPU tensors
(the plain versions) routes mode 0 to K1's sum, so it equals mode 3. Then
DCLNet(voxelization_mode=0, 1, 2) on bridged weights against the JAX
model's exact path within the f32 pose tolerance of
tests/test_torch_model.py (1e-5), and a bf16 DCLNet of mode 1 against JAX
bf16 within the bf16 pose bound (1 degree, 0.5 mm) of
tests/test_torch_bf16_model.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.ops import cuda_voxelize
from dcl_net_tpu_torch.weights import load_jax_variables
from tests.test_torch_bf16_model import ROT_DEG, TRANS_MM, pose_drift
from tests.test_torch_model import _randomise

torch.set_num_threads(2)

# the packages' ops/__init__ export a function `voxelize` over the module's name
jvox = importlib.import_module("dcl_net_tpu.ops.voxelize")
tvox = importlib.import_module("dcl_net_tpu_torch.ops.voxelize")

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 128
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=(256, 64, 16, 8))


def _inputs(unique: bool, masked: bool, seed: int = 0):
    """[3, 300, 5] features on an 8^3 grid: repeated voxels (or, with
    unique, distinct ones per sample) and optionally a mask that kills
    about a third of the points."""
    rng = np.random.RandomState(seed)
    b, n, c = 3, 300, 5
    if unique:
        lin = np.stack([rng.permutation(512)[:n] for _ in range(b)])
        idx = np.stack([lin // 64, lin // 8 % 8, lin % 8], -1).astype(np.int32)
    else:
        idx = rng.randint(0, 8, (b, n, 3)).astype(np.int32)
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = (rng.rand(b, n) > 0.35).astype(np.float32) if masked else None
    return feats, idx, mask


def _both(fn_j, fn_t, feats, idx, mask, **kw):
    want = fn_j(jnp.asarray(feats), jnp.asarray(idx), (8, 8, 8),
                point_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = fn_t(torch.from_numpy(feats), torch.from_numpy(idx), (8, 8, 8),
               point_mask=None if mask is None else torch.from_numpy(mask), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_modes_match_jax_bit_for_bit(mode, masked):
    # mode 0 is for voxels of one point each; 1 and 2 select among many
    feats, idx, mask = _inputs(unique=mode == 0, masked=masked)
    (wg, wc), (gg, gc) = _both(jvox.voxelize_dense, tvox.voxelize_dense, feats, idx, mask,
                               mode=mode)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_array_equal(gc, wc)
    if mode:
        assert (gc > 1).any()  # a real choice was made somewhere


@pytest.mark.parametrize("masked", [False, True])
def test_wrapper_takes_k1_modes_only_and_mode_0_is_its_sum(masked):
    feats, idx, mask = _inputs(unique=False, masked=masked, seed=1)
    args = [torch.from_numpy(feats), torch.from_numpy(idx), (8, 8, 8)]
    kw = {"point_mask": None if mask is None else torch.from_numpy(mask)}
    g0, c0 = tvox.voxelize_dense(*args, mode=0, **kw)
    g3, c3 = cuda_voxelize.voxelize_cuda(*args, mode=3, **kw)
    assert torch.equal(g0, g3) and torch.equal(c0, c3)
    for mode in (0, 1, 2, 5):
        with pytest.raises(ValueError, match=f"voxelize_cuda: mode {mode} "):
            cuda_voxelize.voxelize_cuda(*args, mode=mode, **kw)
    gb, _ = tvox.voxelize_dense(*args, mode=1, out_dtype=torch.bfloat16, **kw)
    first, _ = tvox.voxelize_dense(*args, mode=1, **kw)
    assert gb.dtype == torch.bfloat16 and torch.equal(gb, first.to(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="mode 5"):
        tvox.voxelize_dense(*args, mode=5)


def test_point_recover_matches_jax():
    rng = np.random.RandomState(2)
    grid = rng.randn(2, 6, 7, 8, 4).astype(np.float32)
    idx = np.stack([rng.randint(0, d, (2, 50)) for d in (6, 7, 8)], -1).astype(np.int32)
    want = np.asarray(jvox.point_recover(jnp.asarray(grid), jnp.asarray(idx)))
    got = tvox.point_recover(torch.from_numpy(grid), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    # the rows of the voxels the points were scattered into
    feats, vidx, _ = _inputs(unique=True, masked=False)
    g, _ = tvox.voxelize_dense(torch.from_numpy(feats), torch.from_numpy(vidx), (8, 8, 8),
                               mode=0)
    assert torch.equal(tvox.point_recover(g, torch.from_numpy(vidx)), torch.from_numpy(feats))
    assert tvox.voxelize is tvox.voxelize_dense


@pytest.fixture(scope="module")
def models():
    ds = SyntheticPoseDataset(n_objects=2, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    batch = make_batch([ds[i] for i in range(2)]).to_dict()
    jbatch = jax.tree.map(jnp.asarray, batch)
    init = jax.jit(lambda k, b: JaxDCLNet(n_inp=N, n_tmp=N, **KW).init(k, b, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jbatch))
    variables = {c: _randomise(dict(variables[c]), np.random.RandomState(1))
                 for c in ("params", "batch_stats")}
    return variables, batch, jbatch


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_model_of_each_mode_matches_jax(models, mode):
    variables, batch, jbatch = models
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, voxelization_mode=mode, **KW)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, jbatch)
    tmodel = DCLNet(device="cpu", voxelization_mode=mode, **KW)
    load_jax_variables(tmodel, variables)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for key in ("rot_pred", "trans_pred", "conf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=1e-5, err_msg=key)


def test_bf16_model_of_mode_1_matches_jax_bf16(models):
    variables, batch, jbatch = models
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, voxelization_mode=1, dtype=jnp.bfloat16, **KW)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, jbatch)
    tmodel = DCLNet(device="cpu", voxelization_mode=1, dtype=torch.bfloat16, **KW)
    load_jax_variables(tmodel, variables)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    deg, mm = pose_drift(got["rot_pred"].float().numpy(), got["trans_pred"].float().numpy(),
                         np.asarray(want["rot_pred"], np.float32),
                         np.asarray(want["trans_pred"], np.float32))
    assert deg.max() < ROT_DEG and mm.max() < TRANS_MM, (deg, mm)


def test_dcl_net_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="voxelization mode 5"):
        DCLNet(device="cpu", voxelization_mode=5, **KW)
