"""The port's train-mode DCLNet, losses and gradients against the JAX package.

A JAX DCLNet is initialised (jitted) at small shapes, its running BN
statistics randomised, and carried into the port through weights.py. Both
sides then take one train-mode forward and backward on the same numpy batch
(16^3 grid, N = M = 128, B = 2 with one symmetric and one non-symmetric
sample, distinct classes) against model.apply(..., train=True,
mutable=["batch_stats"]) and jax.value_and_grad(dcl_losses).

Gradients are compared in f64 on both sides (JAX under enable_x64). At this
size the f32 gradient of the network is ill-conditioned: the neck's BN sits
after a ReLU and feeds a confidence-weighted average that is nearly
uniform over the points, so its backward cancels almost everything. In f32
both packages are 1e-2 off their own f64 gradient on some leaves, at
different leaves, so an f32 comparison measures rounding, not semantics.
The forward quantities (losses, running statistics) are compared in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.geometry import rotation as jrot
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu.models import dcl_losses as jax_dcl_losses
from dcl_net_tpu.models import dcl_net as jax_dcl_net
from dcl_net_tpu.models.blocks import PointMLP as JaxPointMLP
from dcl_net_tpu.models.blocks import SparseConvBlock as JaxSparseConvBlock
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.geometry import rotation as trot
from dcl_net_tpu_torch.models import dcl_net as tdcl
from dcl_net_tpu_torch.models.blocks import PointMLP, SparseConvBlock
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.weights import (
    load_jax_variables,
    to_jax_gradients,
    to_jax_variables,
)

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 128
CAPS = (256, 64, 16, 8)
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS)
LOSSES = ("loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "loss_all")


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def as_f64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else np.asarray(a), tree)


def torch_batch(batch, dtype=torch.float32):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.to(dtype) if t.is_floating_point() else t
    return conv(batch_to_torch(batch, "cpu"))


def assert_grads_close(got, want, rel, atol=0.0):
    """Per leaf: max |got - want| <= rel * max |want| + atol."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        scale = np.abs(want[path]).max()
        err = np.abs(got[path] - want[path]).max()
        assert err <= rel * scale + atol, f"{'/'.join(path)}: {err} > {rel} * {scale}"


def assert_stats_close(got, want, atol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=atol,
                                   err_msg="/".join(path))


def build_setup():
    """(JAX model, bridged variables, numpy batch, template bank)."""
    ds = SyntheticPoseDataset(n_objects=2, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    samples = [ds[0], ds[1]]
    assert samples[0]["obj_idx"] != samples[1]["obj_idx"]
    batch = make_batch(samples).to_dict()
    batch["sym_flag"] = np.array([1.0, 0.0], np.float32)
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, **KW)
    init = jax.jit(lambda k, b: jmodel.init(k, b, train=False))
    variables = jax.tree.map(
        np.asarray, init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch)))
    rng = np.random.RandomState(1)
    stats = jax.tree.map(
        lambda a: (rng.randn(*a.shape) * 0.1 + (a > 0.5)).astype(np.float32),
        variables["batch_stats"])  # means near 0, variances near 1
    variables = {"params": variables["params"], "batch_stats": stats}
    return jmodel, variables, batch, ds.template_bank()


@pytest.fixture(scope="module")
def setup():
    return build_setup()


def jax_step(model, variables, batch, bank=None):
    """value_and_grad of dcl_losses in train mode: (losses, grads, stats)."""
    def loss_fn(params, stats, b, bk):
        v = {"params": params, "batch_stats": stats}
        if bk is None:
            pred, mut = model.apply(v, b, train=True, mutable=["batch_stats"])
        else:
            pred, mut = model.apply(v, b, bk, train=True, mutable=["batch_stats"],
                                    method=model.forward_with_template_bank)
        losses = jax_dcl_losses(pred, b)
        return losses["loss_all"], (losses, mut["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, stats)), grads = fn(
        variables["params"], variables["batch_stats"],
        jax.tree.map(jnp.asarray, batch),
        None if bank is None else jax.tree.map(jnp.asarray, bank))
    return (jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, stats))


def torch_step(variables, batch, dtype, bank=None, interp_mode="exact"):
    model = load_jax_variables(DCLNet(interp_mode=interp_mode, device="cpu", **KW),
                               variables).to(dtype)
    model.train()
    tb = torch_batch(batch, dtype)
    if bank is None:
        pred = model(tb)
    else:
        tbank = torch_batch({"b": bank}, dtype)["b"]
        pred = model.forward_with_template_bank(tb, tbank)
    losses = dcl_losses(pred, tb)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(losses["loss_all"],
                                [p for _, p in model.named_parameters()])
    return ({k: float(v) for k, v in losses.items()},
            to_jax_gradients(model, dict(zip(names, grads)))["params"],
            to_jax_variables(model)["batch_stats"])


def test_train_forward_losses_and_stats_match_jax_f32(setup):
    jmodel, variables, batch, _ = setup

    def fwd(v, b):
        pred, mut = jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        return jax_dcl_losses(pred, b), mut["batch_stats"]

    want, want_stats = jax.jit(fwd)(variables, jax.tree.map(jnp.asarray, batch))
    got, _, got_stats = torch_step(variables, batch, torch.float32)
    # f32 forward on both sides, sums in other orders: 1e-5 relative
    for k in LOSSES:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    # running statistics after one update (momentum 0.1 of batch statistics)
    assert_stats_close(got_stats, jax.tree.map(np.asarray, want_stats), 1e-5)


@pytest.mark.parametrize("banked", [False, True], ids=["forward", "template_bank"])
def test_train_step_gradients_match_jax_exact_path_f64(setup, banked):
    jmodel, variables, batch, bank = setup
    bank = bank if banked else None
    v64, b64 = as_f64(variables), as_f64(batch)
    with jax.enable_x64(True):
        want, want_grads, want_stats = jax_step(
            jmodel, v64, b64, None if bank is None else as_f64(bank))
    got, got_grads, got_stats = torch_step(v64, batch, torch.float64, bank)
    # f64 on both sides. The port's voxel centers keep their f32 affine
    # constants (as the JAX package's do), which moves the losses by ~1e-7
    # and the gradients by up to 1e-5 of each leaf's largest entry.
    for k in LOSSES:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    assert_grads_close(got_grads, want_grads, rel=1e-4)
    assert_stats_close(got_stats, want_stats, 1e-5)


def test_gradient_readout_has_the_jax_tree_layout(setup):
    _, variables, batch, _ = setup
    model = load_jax_variables(DCLNet(device="cpu", **KW), variables)
    jgrads = variables["params"]  # any tree of the parameters' layout
    # write each JAX leaf as the port's .grad through the weight bridge's
    # layout, then read the gradients back out
    as_weights = DCLNet(device="cpu", **KW)
    load_jax_variables(as_weights, {"params": jgrads,
                                    "batch_stats": variables["batch_stats"]})
    for (_, p), (_, q) in zip(model.named_parameters(), as_weights.named_parameters()):
        p.grad = q.detach().clone()
    back = to_jax_gradients(model)
    assert set(back) == {"params"}
    got, want = dict(leaves(back["params"])), dict(leaves(jgrads))
    assert set(got) == set(want)
    for path in want:
        assert got[path].shape == want[path].shape
        np.testing.assert_array_equal(got[path], want[path])
    next(model.parameters()).grad = None
    with pytest.raises(KeyError, match="no gradient"):
        to_jax_gradients(model)


def test_ortho9d_gradient_matches_jax():
    rng = np.random.RandomState(3)
    raw = rng.randn(16, 9).astype(np.float64)
    weight = rng.randn(16, 3, 3)

    def jloss(r):
        return jnp.sum(jrot.ortho9d_to_matrix(r[:, :3], r[:, 3:6], r[:, 6:]) * weight)

    with jax.enable_x64(True):
        want = np.asarray(jax.grad(jloss)(jnp.asarray(raw)))
    def tloss(r):
        out = trot.ortho9d_to_matrix(r[:, :3], r[:, 3:6], r[:, 6:])
        return (out * torch.from_numpy(weight)).sum()

    t = torch.from_numpy(raw).requires_grad_(True)
    tloss(t).backward()
    # central differences, f64, step 1e-6: the port's backward through
    # torch.linalg.svd and det is within 1e-8 of them
    fd = np.zeros_like(raw)
    for i, j in np.ndindex(*raw.shape):
        e = np.zeros_like(raw)
        e[i, j] = 1e-6
        fd[i, j] = (float(tloss(torch.from_numpy(raw + e)))
                    - float(tloss(torch.from_numpy(raw - e)))) / 2e-6
    np.testing.assert_allclose(t.grad.numpy(), fd, rtol=0, atol=1e-8)
    # JAX's SVD JVP is itself ~2e-6 from those differences on this input
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-5)


def _random_pred(rng, b=3, n=32):
    def rot():
        q, _ = np.linalg.qr(rng.randn(3, 3))
        return q * np.sign(np.linalg.det(q))
    return {
        "rot_pred": np.stack([rot() for _ in range(b)]),
        "trans_pred": rng.randn(b, 3) * 0.02,
        "conf": rng.uniform(0.05, 0.95, (b, 2 * n)),
        "Xo_pred": rng.randn(b, n, 3) * 0.03,
        "Yc_pred": rng.randn(b, n, 3) * 0.03,
        "points_inp": rng.randn(b, n, 3) * 0.03,
        "points_tmp": rng.randn(b, n, 3) * 0.03,
    }, {
        "labels": {"rot_gt": np.stack([rot() for _ in range(b)]),
                   "trans_gt": rng.randn(b, 3) * 0.02},
        "sym_flag": np.array([1.0, 0.0, 1.0]),
        "valid": np.array([1.0, 1.0, 0.0]),
    }


def test_dcl_losses_and_their_gradients_match_jax():
    pred, batch = _random_pred(np.random.RandomState(5))
    keys = ("rot_pred", "trans_pred", "conf", "Xo_pred", "Yc_pred")

    def jloss(p):
        return jax_dcl_losses({**pred, **p}, batch)

    with jax.enable_x64(True):
        want = jax.tree.map(np.asarray, jloss({k: pred[k] for k in keys}))
        want_grad = jax.tree.map(np.asarray, jax.grad(
            lambda p: jloss(p)["loss_all"])({k: jnp.asarray(pred[k]) for k in keys}))
    tp = {k: torch.from_numpy(v) for k, v in pred.items()}
    for k in keys:
        tp[k].requires_grad_(True)
    tb = {"labels": {k: torch.from_numpy(v) for k, v in batch["labels"].items()},
          "sym_flag": torch.from_numpy(batch["sym_flag"]),
          "valid": torch.from_numpy(batch["valid"])}
    got = dcl_losses(tp, tb)
    for k in LOSSES:  # f64 on both sides
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-12, err_msg=k)
    got["loss_all"].backward()
    for k in keys:  # the detached terms (.detach() for stop_gradient) included
        np.testing.assert_allclose(tp[k].grad.numpy(), want_grad[k], rtol=0,
                                   atol=1e-12, err_msg=k)


def test_get_cano_label_matches_jax():
    pred, batch = _random_pred(np.random.RandomState(6))
    args = (pred["points_tmp"], pred["points_inp"], pred["rot_pred"],
            batch["labels"]["trans_gt"])
    want = jax_dcl_net.get_cano_label(*(jnp.asarray(a, jnp.float32) for a in args))
    got = tdcl.get_cano_label(*(torch.from_numpy(a.astype(np.float32)) for a in args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_point_mlp_train_mode_matches_flax_batch_norm():
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 64, 12) * 2.0 + 1.0).astype(np.float32)
    cot = rng.randn(2, 64, 5).astype(np.float32)
    for bn_before_act in (True, False):
        jm = JaxPointMLP(dims=(8, 5), acts=("relu", "none"), bns=(True, True),
                         bn_before_act=bn_before_act)
        v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False))
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
            v["batch_stats"])

        def f(params, xx):
            y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                              xx, True, mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, mut["batch_stats"])

        (_, (want, want_stats)), (want_grad, want_dx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
        tm = PointMLP(12, (8, 5), ("relu", "none"), (True, True),
                      bn_before_act=bn_before_act)
        load_jax_variables(tm, v)
        tm.train()
        tx = torch.from_numpy(x).requires_grad_(True)
        got = tm(tx)
        (got * torch.from_numpy(cot)).sum().backward()
        # f32 sums in other orders: 1e-5
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                                   rtol=1e-4, atol=1e-5)
        # a Dense bias right before a BN has a zero gradient, rounding only:
        # atol 1e-4 is 5e-6 of the module's largest gradient entries (~20)
        assert_grads_close(to_jax_gradients(tm)["params"],
                           jax.tree.map(np.asarray, want_grad), rel=1e-4, atol=1e-4)
        # the running variance takes flax's biased E[x^2] - E[x]^2
        assert_stats_close(to_jax_variables(tm)["batch_stats"],
                           jax.tree.map(np.asarray, want_stats), 1e-5)


@pytest.mark.parametrize("subm", [True, False])
def test_sparse_conv_block_train_mode_matches_jax(subm):
    rng = np.random.RandomState(8)
    mask = (rng.rand(2, 6, 6, 6) > 0.6).astype(np.float32)
    x = (rng.randn(2, 6, 6, 6, 4) * mask[..., None]).astype(np.float32)
    cot = rng.randn(2, 6, 6, 6, 5).astype(np.float32)
    jm = JaxSparseConvBlock(features=5, subm=subm)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                         jnp.asarray(mask), False))

    def f(params, xx):
        (y, _), mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                               xx, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (want, want_stats)), (want_grad, want_dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm = SparseConvBlock(4, 5, 3, subm=subm)
    load_jax_variables(tm, v)
    tm.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    got, _ = tm(tx, torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    # f32 conv and masked statistics summed in other orders: 1e-5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    assert_grads_close(to_jax_gradients(tm)["params"],
                       jax.tree.map(np.asarray, want_grad), rel=1e-4)
    # unbiased variance for the running update, over the active voxels
    assert_stats_close(to_jax_variables(tm)["batch_stats"],
                       jax.tree.map(np.asarray, want_stats), 1e-5)
