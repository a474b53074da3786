"""The port's stage-1 DCLNet against the JAX package's, on bridged weights.

One JAX DCLNet is initialised (jitted) at small shapes, its BN statistics
and affine parameters randomised so eval-mode folding is exercised, and
carried into the port through weights.py. Both forwards then run on the
same numpy batch: the JAX model on its exact path (interp "exact", voxelize
"scatter") and once on its Pallas path in interpret mode. 16^3 grid,
N = M = 128 (the Pallas interpolation needs N % 128 == 0), B = 2.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.geometry import rotation as jrot
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu.models import MaskedBatchNorm as JaxMaskedBatchNorm
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.geometry import rotation as trot
from dcl_net_tpu_torch.models.blocks import MaskedBatchNorm
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_variables

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 128
CAPS = (256, 64, 16, 8)
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS)


def _randomise(tree, rng):
    """BN statistics and affine parameters away from identity."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "mean":
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k == "bias" and "Dense" not in path[-1]:
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out
    return walk(tree, ())


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticPoseDataset(n_objects=2, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    batch = make_batch([ds[i] for i in range(2)]).to_dict()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, **KW)
    init = jax.jit(lambda k, b: jmodel.init(k, b, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jbatch))
    variables = {c: _randomise(dict(variables[c]), np.random.RandomState(1))
                 for c in ("params", "batch_stats")}
    tmodel = DCLNet(device="cpu", **KW)
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel, batch, jbatch


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_weight_bridge_round_trip_is_bit_equal(setup):
    _, variables, tmodel, _, _ = setup
    _assert_trees_equal(to_jax_variables(tmodel), variables)


def test_weight_bridge_rejects_unmapped_and_missing(setup):
    _, variables, _, _, _ = setup
    extra = {c: dict(variables[c]) for c in variables}
    extra["params"]["regressor_rot"] = dict(extra["params"]["regressor_rot"])
    extra["params"]["regressor_rot"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_jax_variables(DCLNet(device="cpu", **KW), extra)
    missing = {c: dict(variables[c]) for c in variables}
    del missing["batch_stats"]["neck_fuser"]
    with pytest.raises(KeyError, match="no JAX counterpart"):
        load_jax_variables(DCLNet(device="cpu", **KW), missing)


def test_forward_matches_jax_exact_path(setup):
    jmodel, variables, tmodel, batch, jbatch = setup
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, jbatch)
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        got = tmodel(tb)
    # f32 on both sides; sums (convs, matmuls, window sums) in other orders.
    # The port's 3-NN uses direct-difference distances where the JAX exact
    # path uses the expansion form: about 1e-5 through the whole network.
    for key in ("rot_pred", "trans_pred", "conf", "Xo_pred", "Yc_pred"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["overflow"].numpy(), np.asarray(want["overflow"]))

    # the 480-channel per-point features of both branches
    def enc(m, f, i, side):
        bb, pf = ((m.backbone_inp, m.point_feats_inp) if side == "inp"
                  else (m.backbone_tmp, m.point_feats_tmp))
        return m._encode(bb, pf, f, i, False)[1]

    for side in ("inp", "tmp"):
        jf = jax.jit(lambda v, f, i: jmodel.apply(v, f, i, side, method=enc))(
            variables, jbatch[side]["feats"], jbatch[side]["voxel_idx"])
        with torch.no_grad():
            bb = tmodel.backbone_inp if side == "inp" else tmodel.backbone_tmp
            pf = tmodel.point_feats_inp if side == "inp" else tmodel.point_feats_tmp
            tf = tmodel._encode(bb, pf, tb[side]["feats"], tb[side]["voxel_idx"])[1]
        assert tf.shape == (2, N, 480)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)


def test_forward_matches_jax_pallas_path(setup):
    _, variables, tmodel, batch, jbatch = setup
    pallas = JaxDCLNet(interp_mode="pallas", voxelize_impl="matmul", n_inp=N,
                       n_tmp=N, **KW)
    want = jax.jit(lambda v, b: pallas.apply(v, b, train=False))(variables, jbatch)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    # the port follows the Pallas kernels' arithmetic (direct differences,
    # the same top 3): 1e-5 covers the remaining sums in other orders
    for key in ("rot_pred", "trans_pred", "conf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_eval_mode_only(setup):
    tmodel = setup[2]
    tmodel.train()
    try:
        with pytest.raises(NotImplementedError, match="eval mode"):
            tmodel(batch_to_torch(setup[3], "cpu"))
    finally:
        tmodel.eval()


@pytest.mark.parametrize("train", [False, True])
def test_masked_batch_norm_matches_jax(train):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 4, 4, 6).astype(np.float32)
    mask = (rng.rand(2, 4, 4, 4) > 0.5).astype(np.float32)
    jm = JaxMaskedBatchNorm()
    v = {"params": {"scale": rng.uniform(0.8, 1.2, 6).astype(np.float32),
                    "bias": rng.randn(6).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(6).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    want, upd = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), train,
                         mutable=["batch_stats"])
    tm = MaskedBatchNorm(6)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        tm.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        tm.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        tm.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-7)


def test_ortho9d_to_matrix_matches_jax():
    rng = np.random.RandomState(2)
    raw = rng.randn(16, 9).astype(np.float32)
    got = trot.ortho9d_to_matrix(*(torch.from_numpy(raw[:, i:i + 3]) for i in (0, 3, 6)))
    want = jrot.ortho9d_to_matrix(*(jnp.asarray(raw[:, i:i + 3]) for i in (0, 3, 6)))
    # both polish an f32 SVD with two Newton-Schulz steps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, atol=1e-5)
