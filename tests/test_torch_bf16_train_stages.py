"""The stages of a bf16 train step (model.compute_dtype: bfloat16) against
the JAX package's, each on the same inputs.

A whole bf16 train step of the small test network cannot tell a departure
of the port from bf16 rounding (tests/test_torch_bf16_train_model.py says
why: in train mode the BN statistics are f32 sums, which torch and XLA take
in other orders, and every bf16 rounding after them turns those last-bit
differences into whole-ulp ones, so by the heads two correct bf16 steps are
as far apart as bf16 is from f32). So each stage of the step runs here on
the port's own bf16 inputs to it, through the port and through the JAX
module, forward and backward (a seeded bf16 cotangent), in train mode:
every block of the observed backbone and its pools, the point features on
both Pallas paths (K2 + K3 with K4 + K5 backward, K2 + K6 with K7), the
four disengage heads, and fuse with the losses. Each quantity (outputs, the
input's gradient, the parameters' gradients, the updated BN statistics) is
held to the JAX bf16 stage by a relative L2 norm at most RATIO times the
JAX bf16 stage's own distance from the JAX f32 stage on the same inputs:
the port rounds where JAX's bf16 does, and what is left is the order of
the f32 sums.

The JAX stages are compiled with XLA's excess precision off
(xla_allow_excess_precision=False), so that XLA rounds where the JAX
program does. By default XLA's CPU backend keeps f32 where a bf16 value is
widened right after it is rounded: the bf16 output of a convolution or a
dense layer going into a train-mode BN, whose statistics are f32. The port,
like cuDNN and cuBLAS on the card, rounds it.

16^3 grid, N = 128, batch 4, SyntheticPoseDataset(seed=0), PRNGKey(0)
weights.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu.models import dcl_losses as jax_dcl_losses
from dcl_net_tpu.models.backbone import MultiScalePointFeatures as JaxPointFeatures
from dcl_net_tpu.models.blocks import PointMLP as JaxPointMLP
from dcl_net_tpu.models.blocks import SparseConvBlock as JaxSparseConvBlock
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.ops import sparse_conv as tsc
from dcl_net_tpu_torch.ops.cuda_voxelize import voxelize_cuda
from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_gradients, to_jax_variables

torch.set_num_threads(2)

BF16 = torch.bfloat16
GRID, UNIT, N, B = (16, 16, 16), (0.024, 0.024, 0.024), 128, 4
CAPS = (256, 64, 16, 8)
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS)
DIMS = (7, 16, 32, 32, 64, 64, 128, 128, 256)
HEADS = (("p1", 256), ("m1", 64), ("p2", 256), ("m2", 64))
# port vs JAX bf16, as a share of JAX bf16 vs JAX f32 on the same inputs
RATIO = 0.5


def strict(fn, *args):
    """fn jitted and run with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def f64(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, np.float64)


def to_jax(t: torch.Tensor, dtype=jnp.bfloat16):
    """A torch tensor as a JAX array of `dtype` (bf16 values exactly)."""
    return jnp.asarray(t.detach().float().numpy()).astype(dtype)


def rel_l2(got, want) -> float:
    """Relative L2 distance of two lists of arrays, taken together."""
    got, want = [f64(g) for g in got], [f64(w) for w in want]
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum(w ** 2)) for w in want)
    return float(np.sqrt(num / den))


def assert_tracks(name, port, j16, j32):
    """port within RATIO of the JAX bf16-vs-f32 distance from JAX bf16 (equal
    to it where bf16 gives the f32 values)."""
    err, ref = rel_l2(port, j16), rel_l2(j16, j32)
    assert err <= RATIO * ref, f"{name}: port vs JAX bf16 {err:.3g} > {RATIO} x {ref:.3g}"


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def cotangent(seed, shape, dtype=BF16):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


@pytest.fixture(scope="module")
def setup():
    """The bridged bf16 model in train mode, the batch, the JAX variables,
    and the port's bf16 inputs of each stage of the observed branch."""
    ds = SyntheticPoseDataset(n_objects=4, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    batch = make_batch([ds[i] for i in range(B)]).to_dict()
    batch["sym_flag"] = (np.arange(B) % 2 == 0).astype(np.float32)
    jm = JaxDCLNet(n_inp=N, n_tmp=N, **KW)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, b: jm.init(k, b, train=False))(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch)))
    model = load_jax_variables(DCLNet(interp_mode="pallas", device="cpu", dtype=BF16, **KW),
                               variables)
    model.train()
    tb = batch_to_torch(batch, "cpu")
    feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
    stages = {}
    with torch.no_grad():
        frozen = copy.deepcopy(model)  # its statistics move; the stages' do not
        grid, count = voxelize_cuda(feats, vidx, GRID, mode=4, out_dtype=BF16)
        x, m = grid, (count > 0).to(torch.float32)
        pyramid = []
        bb = frozen.backbone_inp
        for i in range(bb.n_layers):
            stages[f"conv{i}"] = (x, m)
            x, m = getattr(bb, f"conv{i}")(x, m)
            if i in bb.module_end:
                stages[f"pool{len(pyramid)}"] = (x, m)
                x, m = tsc.sparse_avg_pool(x, m, 3, 2)
                pyramid.append((x, m))
        points = feats[..., 4:7].contiguous()
        stages["pyramid"] = (points, pyramid)
        interp, _ = frozen.point_feats_inp(points, pyramid)
        stages["interp"] = interp
        obs = frozen.encode_observed(tb)
        tmp = frozen.encode_template(tb)
    stages["fuse"] = (obs, tmp)
    return model, tb, batch, variables, stages


def jax_vjp(apply, params, x, cot):
    """(outputs, d params, d x, updated BN statistics) of apply(params, x)
    -> (y, stats), by jax.vjp with cotangent cot."""
    y, f_vjp, stats = jax.vjp(apply, params, x, has_aux=True)
    dp, dx = f_vjp(cot)
    return y, dp, dx, stats


def port_vjp(module, x, cot, call=None):
    """The port's stage in train mode on a copy of `module`: {out, dx,
    dparams, stats} in the JAX tree's layout (weights.py), cot the output's
    cotangent."""
    module = copy.deepcopy(module)
    xt = x.clone().requires_grad_(True)
    y = call(module, xt) if call else module(xt)
    y.backward(cot)
    assert {p.grad.dtype for p in module.parameters()} == {torch.float32}
    variables = to_jax_variables(module)
    return dict(out=[y], dx=[xt.grad], dparams=leaves(to_jax_gradients(module)["params"]),
                stats=leaves(variables.get("batch_stats", {})))


def jax_stage(make, sub, x, cot):
    """The JAX stage `make(dtype)` on the same inputs in bf16 and in f32:
    {dtype: {out, dx, dparams, stats}}; the bf16 one compiled strictly."""
    out = {}
    for dt, xdt in ((jnp.bfloat16, jnp.bfloat16), (None, jnp.float32)):
        module, call = make(dt)

        def apply(p, xx, module=module, call=call):
            y, mut = call(module, {"params": p, "batch_stats": sub.get("batch_stats", {})}, xx)
            return y, mut

        y, dp, dx, st = strict(lambda p, xx, ct: jax_vjp(apply, p, xx, ct.astype(xdt)),
                               sub["params"], to_jax(x, xdt), to_jax(cot, xdt))
        out[dt] = dict(out=[y], dx=[dx], dparams=leaves(dp), stats=leaves(st))
    return out


def assert_stage_tracks(name, port, jax_out):
    for k in ("out", "dx", "dparams", "stats"):
        if port[k]:
            assert_tracks(f"{name} {k}", port[k], jax_out[jnp.bfloat16][k], jax_out[None][k])


@pytest.mark.parametrize("i", range(8))
def test_bf16_sparse_conv_block_train_step_matches_jax(setup, i):
    model, _, _, variables, stages = setup
    x, m = stages[f"conv{i}"]
    cot = cotangent(i, x.shape[:-1] + (DIMS[i + 1],))
    port = port_vjp(getattr(model.backbone_inp, f"conv{i}"), x, cot,
                    call=lambda blk, xt: blk(xt, m)[0])
    assert port["out"][0].dtype == BF16 and port["dx"][0].dtype == BF16
    sub = {k: variables[k]["backbone_inp"][f"conv{i}"] for k in ("params", "batch_stats")}
    subm = not (i == 0 or (i - 1) in (1, 3, 5))
    mask = jnp.asarray(m.numpy())

    def make(dt):
        def call(module, v, xx):
            (y, _), mut = module.apply(v, xx, mask, True, mutable=["batch_stats"])
            return y, mut["batch_stats"]
        return JaxSparseConvBlock(features=DIMS[i + 1], subm=subm, dtype=dt), call

    assert_stage_tracks(f"conv{i}", port, jax_stage(make, sub, x, cot))


@pytest.mark.parametrize("level", range(4))
def test_bf16_sparse_avg_pool_gradient_matches_jax(setup, level):
    """The bf16 window sum's three rounded passes, forward and backward (the
    port differentiates its passes; XLA transposes its three bf16
    convolutions, each rounded)."""
    _, _, _, _, stages = setup
    x, m = stages[f"pool{level}"]
    pooled = tuple((d + 1) // 2 for d in x.shape[1:4])  # kernel 3, stride 2, pad 1
    cot = cotangent(10 + level, (x.shape[0],) + pooled + (x.shape[4],))
    xt = x.clone().requires_grad_(True)
    y, _ = tsc.sparse_avg_pool(xt, m, 3, 2)
    y.backward(cot)
    assert y.dtype == xt.grad.dtype == BF16
    mask = jnp.asarray(m.numpy())
    out = {}
    for xdt in (jnp.bfloat16, jnp.float32):
        def fn(xx, ct):
            y, f_vjp = jax.vjp(lambda v: jsc.sparse_avg_pool(v, mask, 3, 2)[0], xx)
            return y, f_vjp(ct)[0]
        out[xdt] = strict(fn, to_jax(x, xdt), to_jax(cot, xdt))
    for k, name in ((0, "out"), (1, "dx")):
        got = (y, xt.grad)[k]
        assert_tracks(f"pool{level} {name}", [got], [out[jnp.bfloat16][k]],
                      [out[jnp.float32][k]])


@pytest.mark.parametrize("mode", ["pallas", "pallas_fused"])
def test_bf16_point_features_gradient_matches_jax(setup, mode):
    """K2 + K3 (K4 and K5 backward) or K2 + K6 (K7 backward) in bf16 on the
    port's pyramid, against the JAX Pallas path in interpret mode: the
    interpolated features and the four levels' gradients."""
    model, _, _, _, stages = setup
    points, pyramid = stages["pyramid"]
    cot = cotangent(20, (B, N, 480))
    pf = copy.deepcopy(model.point_feats_inp)
    pf.interp_mode = mode
    grids = [f.clone().requires_grad_(True) for f, _ in pyramid]
    out, _ = pf(points, [(g, m) for g, (_, m) in zip(grids, pyramid)])
    assert out.dtype == BF16
    out.backward(cot)
    assert {g.grad.dtype for g in grids} == {BF16}
    jpf = JaxPointFeatures(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS,
                           interp_mode=mode)
    masks = [jnp.asarray(m.numpy()) for _, m in pyramid]
    jp = jnp.asarray(points.numpy())
    res = {}
    for xdt in (jnp.bfloat16, jnp.float32):
        def fn(fs, ct):
            def f(fs):
                return jpf.apply({}, jp, list(zip(fs, masks)))[0]
            y, f_vjp = jax.vjp(f, fs)
            return y, f_vjp(ct)[0]
        res[xdt] = strict(fn, [to_jax(f, xdt) for f, _ in pyramid], to_jax(cot, xdt))
    assert_tracks(f"{mode} out", [out], [res[jnp.bfloat16][0]], [res[jnp.float32][0]])
    assert_tracks(f"{mode} d levels", [g.grad for g in grids], res[jnp.bfloat16][1],
                  res[jnp.float32][1])


@pytest.mark.parametrize("head", [h for h, _ in HEADS])
def test_bf16_disengage_head_train_step_matches_jax(setup, head):
    model, _, _, variables, stages = setup
    x = stages["interp"]
    dim = dict(HEADS)[head]
    cot = cotangent(30, (B, N, dim))
    name = f"disengage_Xc_{head}"
    port = port_vjp(getattr(model, name), x, cot)
    assert port["out"][0].dtype == port["dx"][0].dtype == BF16
    sub = {k: variables[k][name] for k in ("params", "batch_stats")}

    def make(dt):
        def call(module, v, xx):
            y, mut = module.apply(v, xx, True, mutable=["batch_stats"])
            return y, mut["batch_stats"]
        return JaxPointMLP(dims=(256, dim), acts=("relu", "relu"), bns=(True, True),
                           bn_before_act=True, use_bias=False, dtype=dt), call

    assert_stage_tracks(head, port, jax_stage(make, sub, x, cot))


def test_bf16_fuse_and_losses_gradient_matches_jax(setup):
    """fuse (attention, confidence, neck, pose heads, SVD) and dcl_losses in
    train mode on the port's bf16 head outputs of both branches: the losses,
    the fused outputs, the gradients of fuse's parameters and of its bf16
    inputs, and the updated BN statistics."""
    model, tb, batch, variables, stages = setup
    obs, tmp = stages["fuse"]
    keys = [h for h, _ in HEADS]
    m = copy.deepcopy(model)
    o = {k: (v.detach().clone().requires_grad_(True) if k in keys else v)
         for k, v in obs.items()}
    t = {k: (v.detach().clone().requires_grad_(True) if k in keys else v)
         for k, v in tmp.items()}
    out = m.fuse(o, t)
    losses = dcl_losses(out, tb)
    losses["loss_all"].backward()
    fused = [n for n, _ in m.named_children() if not n.startswith(
        ("backbone", "point_feats", "disengage"))]
    port_dp = [x for n in fused for x in leaves(to_jax_gradients(getattr(m, n))["params"])]
    port_st = [x for n in fused
               for x in leaves(to_jax_variables(getattr(m, n)).get("batch_stats", {}))]
    port_dx = [o[k].grad for k in keys] + [t[k].grad for k in keys]
    assert {x.dtype for x in port_dx} == {BF16}
    outs = ("Xo_pred", "Yc_pred", "conf", "F_Xo_p", "trans_pred")

    jb = jax.tree.map(jnp.asarray, batch)
    fixed = {s: {k: jnp.asarray(d[k].numpy()) for k in ("points", "overflow")}
             for s, d in (("o", obs), ("t", tmp))}
    res = {}
    for dt in (jnp.bfloat16, None):
        xdt = dt or jnp.float32
        jm = JaxDCLNet(n_inp=N, n_tmp=N, dtype=dt, **KW)
        params = {n: variables["params"][n] for n in fused}

        def fn(p, ins, jm=jm):
            def loss(p, ins):
                v = {"params": {**variables["params"], **p},
                     "batch_stats": variables["batch_stats"]}
                po = dict(ins[0], **fixed["o"])
                pt = dict(ins[1], **fixed["t"])
                pred, mut = jm.apply(v, po, pt, True, method=jm.fuse,
                                     mutable=["batch_stats"])
                ls = jax_dcl_losses(pred, jb)
                return ls["loss_all"], (ls, pred, mut["batch_stats"])
            return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, ins)

        ins = tuple({k: to_jax(d[k], xdt) for k in keys} for d in (obs, tmp))
        (_, (ls, pred, st)), (dp, dins) = strict(fn, params, ins)
        res[dt] = dict(losses=[ls[k] for k in sorted(ls)], out=[pred[k] for k in outs],
                       dparams=[x for n in fused for x in leaves(dp[n])],
                       stats=[x for n in fused for x in leaves(st.get(n, {}))],
                       dx=[dins[0][k] for k in keys] + [dins[1][k] for k in keys])
    port = dict(losses=[losses[k].detach() for k in sorted(losses)],
                out=[out[k] for k in outs], dparams=port_dp, stats=port_st, dx=port_dx)
    for k in port:
        assert_tracks(f"fuse {k}", port[k], res[jnp.bfloat16][k], res[None][k])
