"""The port's PointNet++ ops and modules against the JAX package's.

dcl_net_tpu_torch/ops/knn.py (gather_operation and grouping_operation with
their gradients, furthest_point_sample with and without a mask,
ball_query) and ops/pointnet_modules.py (query_and_group, knn_and_group,
group_all, PointnetSAModuleMSG, PointnetSAModule, PointnetFPModule)
against dcl_net_tpu/ops/ on the same numpy-seeded inputs. The modules run
on JAX's initial weights, their BN statistics and affine parameters moved
away from identity, bridged by weights.py: outputs, parameter gradients
and the running statistics after a train-mode forward within 1e-5, in
eval and in train mode. Integer outputs are exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.ops import pointnet_modules as jpm
from dcl_net_tpu_torch.ops import pointnet_modules as tpm
from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_gradients, to_jax_variables
from tests.test_torch_model import _randomise
from tests.test_torch_train_model import assert_grads_close, assert_stats_close

torch.set_num_threads(2)

# the packages' ops/__init__ export a function `knn` over the module's name
jknn = importlib.import_module("dcl_net_tpu.ops.knn")
tknn = importlib.import_module("dcl_net_tpu_torch.ops.knn")

TOL = 1e-5


def _cloud(seed, b=2, n=128, c=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32) * 0.1,
            rng.randn(b, n, c).astype(np.float32))


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("op", ["gather_operation", "grouping_operation"])
def test_gathers_and_their_gradients_match_jax(op):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 31, 6).astype(np.float32)
    shape = (2, 9) if op == "gather_operation" else (2, 7, 5)
    idx = rng.randint(0, 31, size=shape).astype(np.int32)
    want, vjp = jax.vjp(lambda f: getattr(jknn, op)(f, jnp.asarray(idx)), jnp.asarray(feats))
    ft = T(feats).requires_grad_(True)
    got = getattr(tknn, op)(ft, T(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    dout = rng.randn(*want.shape).astype(np.float32)
    (got * T(dout)).sum().backward()
    (wgrad,) = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(wgrad), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_furthest_point_sample_matches_jax(masked):
    xyz, _ = _cloud(1, n=300)
    mask = (np.random.RandomState(2).rand(2, 300) > 0.3).astype(np.float32) if masked else None
    want = jknn.furthest_point_sample(jnp.asarray(xyz), 64,
                                      None if mask is None else jnp.asarray(mask))
    got = tknn.furthest_point_sample(T(xyz), 64, None if mask is None else T(mask))
    assert got.dtype == torch.int32 and got.shape == (2, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == 0).all()
    if masked:  # index 0 is taken first; no later pick is masked
        assert (T(mask).gather(1, got[:, 1:].long()) > 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_matches_jax(masked):
    xyz, _ = _cloud(3, n=64)
    rng = np.random.RandomState(4)
    centers = rng.randn(2, 9, 3).astype(np.float32) * 0.1
    centers[0, 0] = 5.0  # an empty ball
    mask = (rng.rand(2, 64) > 0.4).astype(np.float32) if masked else None
    want = jknn.ball_query(0.08, 8, jnp.asarray(xyz), jnp.asarray(centers),
                           None if mask is None else jnp.asarray(mask))
    got = tknn.ball_query(0.08, 8, T(xyz), T(centers), None if mask is None else T(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grouping_functions_match_jax():
    xyz, feats = _cloud(5)
    new_xyz = xyz[:, :32]
    j = [jnp.asarray(a) for a in (xyz, new_xyz, feats)]
    t = [T(a) for a in (xyz, new_xyz, feats)]
    for use_xyz in (True, False):
        pairs = [
            (jpm.query_and_group(j[0], j[1], 0.2, 8, j[2], use_xyz),
             tpm.query_and_group(t[0], t[1], 0.2, 8, t[2], use_xyz)),
            (jpm.knn_and_group(6, j[0], j[1], j[2], use_xyz),
             tpm.knn_and_group(6, t[0], t[1], t[2], use_xyz)),
            (jpm.group_all(j[0], j[2], use_xyz), tpm.group_all(t[0], t[2], use_xyz)),
        ]
        for want, got in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpm.query_and_group(t[0], t[1], 0.2, 8).numpy(),
                                  np.asarray(jpm.query_and_group(j[0], j[1], 0.2, 8)))
    np.testing.assert_array_equal(tpm.group_all(t[0], None).numpy(),
                                  np.asarray(jpm.group_all(j[0], None)))


def _bridged(jmod, tmod, args):
    """JAX's initial variables, BN moved from identity, in both modules."""
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), *args, True))
    v = {c: _randomise(dict(v[c]), np.random.RandomState(1)) for c in ("params", "batch_stats")}
    return v, load_jax_variables(tmod, v)


MODULES = {
    "sa_msg": lambda: (jpm.PointnetSAModuleMSG(npoint=32, radii=[0.1, 0.2], nsamples=[8, 16],
                                               mlps=[[16, 16], [16, 32]]),
                       tpm.PointnetSAModuleMSG(32, [0.1, 0.2], [8, 16], [[16, 16], [16, 32]],
                                               in_channels=8, device="cpu")),
    # the JAX PointnetSAModule cannot be initialised (flax re-runs a module's
    # dataclass __init__, which its own __init__ replaces): the single-scale
    # module is held to the JAX MSG module of one scale, which it subclasses
    "sa": lambda: (jpm.PointnetSAModuleMSG(npoint=16, radii=[0.15], nsamples=[8],
                                           mlps=[[16, 24]]),
                   tpm.PointnetSAModule([16, 24], npoint=16, radius=0.15, nsample=8,
                                        in_channels=8, device="cpu")),
    "sa_all": lambda: (jpm.PointnetSAModuleMSG(npoint=None, radii=[None], nsamples=[None],
                                               mlps=[[16, 24]]),
                       tpm.PointnetSAModule([16, 24], in_channels=8, device="cpu")),
    "fp": lambda: (jpm.PointnetFPModule(mlp=[32, 16]),
                   tpm.PointnetFPModule([32, 16], in_channels=8 + 8, device="cpu")),
}


def _args(name, xyz, feats):
    if name == "fp":
        return (xyz, xyz[:, :40], feats, feats[:, :40] * 0.5)
    return (xyz, feats)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(MODULES))
def test_modules_match_jax_on_bridged_weights(name, train):
    xyz, feats = _cloud(6)
    jmod, tmod = MODULES[name]()
    jargs = tuple(jnp.asarray(a) for a in _args(name, xyz, feats))
    variables, tmod = _bridged(jmod, tmod, jargs)
    assert set(to_jax_variables(tmod)["params"]) == set(variables["params"])
    rng = np.random.RandomState(7)

    def out_of(res):
        return res[1] if isinstance(res, tuple) else res

    want_res, mut = jmod.apply(variables, *jargs, train, mutable=["batch_stats"])
    want = np.asarray(out_of(want_res))
    dout = rng.randn(*want.shape).astype(np.float32)

    def loss(params):
        res, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            *jargs, train, mutable=["batch_stats"])
        return jnp.sum(out_of(res) * dout)

    want_grads = jax.tree.map(np.asarray, jax.grad(loss)(variables["params"]))
    tmod.train(train)
    got_res = tmod(*(T(a) for a in _args(name, xyz, feats)))
    if isinstance(got_res, tuple):
        np.testing.assert_array_equal(got_res[0].numpy(), np.asarray(want_res[0]))
    got = out_of(got_res)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    (got * T(dout)).sum().backward()
    assert_grads_close(to_jax_gradients(tmod)["params"], want_grads, rel=TOL, atol=TOL)
    assert_stats_close(to_jax_variables(tmod)["batch_stats"],
                       jax.tree.map(np.asarray, mut["batch_stats"]), TOL)
