"""The port's serving artifacts (dcl_net_tpu_torch/serving.py) against the
JAX package's (dcl_net_tpu/serving.py), on the same weights.

At the JAX serving tests' size (tests/test_serving.py: 16^3 grid, N = M =
64, capacities (256, 64, 16, 8), 3 classes, batch 4), one JAX DCLNet is
initialised and carried into the port by weights.load_jax_variables. A .pt2
artifact, saved and loaded again, must be torch.equal to the port's direct
serving module on the CPU, and within 1e-5 of JAX's make_serve_fn (the bound
of tests/test_torch_model.py); the same for the batch-polymorphic artifact against the fixed ones, for BundleServer at every
request size the JAX tests use, and for a bf16 artifact against the port's
direct bf16 serve. The exported graphs name the dclx ops and hold no
data-dependent symbol. Stage 2: tests/test_torch_serving_stage2.py.
"""

import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu import serving as jserving
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu_torch import serving
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.ops.voxelize import point_to_voxel_index
from dcl_net_tpu_torch.weights import load_jax_variables

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 64
C_CLASSES = 3
CAPS = (256, 64, 16, 8)
B = 4
ATOL = 1e-5
KEYS = {"rot_pred", "trans_pred", "conf", "overflow"}
ITERATIONS = 2


def _cloud(rng, b):
    pts = (rng.rand(b, N, 3).astype(np.float32) - 0.5) * 0.15
    rgb = rng.rand(b, N, 3).astype(np.float32) - 0.5
    feats = np.concatenate([np.ones((b, N, 1), np.float32), rgb, pts], -1)
    return feats, point_to_voxel_index(torch.from_numpy(pts), UNIT, GRID).numpy()


def _jax_variables(jmodel, bank, feats, vi, obj_idx, seed):
    init_batch = {
        "inp": {"feats": jnp.asarray(feats), "voxel_idx": jnp.asarray(vi)},
        "tmp": {"feats": jnp.asarray(bank["feats"][obj_idx]),
                "voxel_idx": jnp.asarray(bank["voxel_idx"][obj_idx])},
    }
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(seed), init_batch, train=False)
    return jax.tree.map(np.asarray, variables)


def _port_model(variables, dtype=None):
    model = DCLNet(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS,
                   device="cpu", dtype=dtype)
    return load_jax_variables(model, variables)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    bank_feats, bank_vi = _cloud(rng, C_CLASSES)
    bank = {"feats": bank_feats, "voxel_idx": bank_vi}
    feats, vi = _cloud(rng, B)
    obj_idx = rng.randint(0, C_CLASSES, size=(B,)).astype(np.int32)
    jmodel = JaxDCLNet(unit_voxel_extent=UNIT, voxel_num_limit=GRID, n_inp=N, n_tmp=N,
                       capacities=CAPS)
    variables = _jax_variables(jmodel, bank, feats, vi, obj_idx, seed=0)
    return dict(jmodel=jmodel, variables=variables, model=_port_model(variables),
                bank=bank, feats=feats, vi=vi, obj_idx=obj_idx)


def _args(s, rows=None):
    idx = slice(None) if rows is None else rows
    return (torch.from_numpy(s["feats"][idx]), torch.from_numpy(s["vi"][idx]),
            torch.from_numpy(s["obj_idx"][idx]))


def _direct(s, model=None):
    model = model or s["model"]
    return serving.make_serve_fn(model, serving.encode_template_cache(model, s["bank"]))


def _jax_direct(s, rows=None, stage2=None):
    """JAX's direct serve of the rows; stage2: (refiner, its variables)."""
    jmodel, variables = s["jmodel"], s["variables"]
    cache = jserving.encode_template_cache(jmodel, variables, s["bank"])
    if stage2 is None:
        fn = jserving.make_serve_fn(jmodel, variables, cache)
    else:
        fn = jserving.make_serve_fn_stage2(jmodel, variables, *stage2, cache, ITERATIONS)
    return jax.jit(fn)(*(jnp.asarray(a.numpy()) for a in _args(s, rows)))


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _assert_close_to_jax(got, want, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def bundle(setup, tmp_path_factory):
    """A stage-1 bundle of fixed batches 2 and 4 and the poly artifact: its
    directory, the bytes and each artifact loaded from its file."""
    arts = serving.export_bundle(setup["model"], setup["bank"], N, batch_sizes=(2, 4))
    assert set(arts) == {"b00002", "b00004", "poly"}
    bdir = tmp_path_factory.mktemp("bundle")
    serving.save_bundle(str(bdir), arts, setup["model"])
    fns = {name: serving.load_serve(str(bdir / f"{name}.pt2")) for name in arts}
    return bdir, arts, fns


@pytest.fixture(scope="module")
def jax_rows(setup):
    """JAX's direct serve of 7 rows (the batch's 4, then its first 3):
    every request of test_bundle_serves_any_request_size is a prefix, and
    eval rows do not depend on the batch."""
    rows = np.resize(np.arange(B), 7)
    return rows, {k: np.asarray(v) for k, v in _jax_direct(setup, rows).items()}


def test_export_roundtrip_matches_direct_and_jax(setup, bundle, jax_rows):
    """The batch-4 artifact, loaded from its file, equals the direct serve
    bit for bit and JAX's make_serve_fn within 1e-5."""
    got = bundle[2]["b00004"](*_args(setup))
    assert set(got) == KEYS
    assert got["rot_pred"].shape == (B, 3, 3) and got["conf"].shape == (B, 2 * N)
    assert got["overflow"].dtype == torch.bool
    with torch.no_grad():
        _assert_equal(got, _direct(setup)(*_args(setup)))
    _assert_close_to_jax(got, {k: v[:B] for k, v in jax_rows[1].items()})


def test_export_artifact_is_weight_dependent(setup, bundle):
    """Other weights give another artifact output: the weights are carried,
    not the export-time constants of one model."""
    other = DCLNet(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS,
                   device="cpu", seed=1)
    o1 = bundle[2]["b00004"](*_args(setup))
    o2 = serving.load_serve(serving.export_serve(other, setup["bank"], B, N))(*_args(setup))
    assert (o1["trans_pred"] - o2["trans_pred"]).abs().max() > 1e-6


def test_poly_artifact_matches_the_fixed_ones(setup, bundle):
    """The batch-polymorphic artifact equals the fixed-batch ones at their
    batches, and serves a batch neither was traced at."""
    fns = bundle[2]
    poly = fns["poly"]
    for b in (2, 4):
        fixed = fns[f"b{b:05d}"]
        got = poly(*_args(setup, slice(0, b)))
        assert got["rot_pred"].shape == (b, 3, 3)
        _assert_equal(got, fixed(*_args(setup, slice(0, b))))
    got = poly(*_args(setup, slice(0, 3)))
    with torch.no_grad():
        _assert_equal(got, _direct(setup)(*_args(setup, slice(0, 3))))


def test_exported_graphs_name_the_ops_and_no_data_dependent_symbol(setup, bundle):
    """Each artifact's graph calls K1, K2 and K3 as dclx ops. The fixed one
    has no symbol, the poly one only its batch, backed and bounded by
    poly_max_batch (the unchunked pools). No example batch is saved."""
    arts = bundle[1]
    bound = serving.poly_max_batch(setup["model"])
    assert bound == setup["model"].backbone_inp.unchunked_batch(GRID) == 5753
    for name in ("b00004", "poly"):
        program = torch.export.load(io.BytesIO(arts[name]))
        assert program.example_inputs is None  # no zero batch stored beside the weights
        targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        ops = {t for t in targets if t.startswith("dclx.")}
        assert ops == {"dclx.voxelize.default", "dclx.dense_to_sparse.default",
                       "dclx.nn_interpolate.default"}, targets
        ranges = program.range_constraints
        if name == "poly":
            (sym, vr), = ranges.items()
            assert str(sym).startswith("s") and (int(vr.lower), int(vr.upper)) == (1, bound)
        else:
            assert not ranges


def test_bundle_serves_any_request_size(setup, bundle, jax_rows):
    """BundleServer pads into the smallest fitting fixed artifact or chunks
    past the largest; each row is within 1e-5 of JAX's direct serve."""
    server = serving.BundleServer(str(bundle[0]))
    assert server.fixed_sizes == [2, 4] and server.has_poly
    assert server.device == torch.device("cpu") and server.dtype == "float32"
    rows, ref = jax_rows
    for n in (1, 2, 3, 4, 5, 7):
        idx = rows[:n]
        got = server(setup["feats"][idx], setup["vi"][idx], setup["obj_idx"][idx])
        assert got["rot_pred"].shape == (n, 3, 3) and got["overflow"].shape == (n,)
        _assert_close_to_jax(got, {k: v[:n] for k, v in ref.items()},
                             keys=("rot_pred", "trans_pred", "conf"))
        np.testing.assert_array_equal(got["overflow"].numpy(), ref["overflow"][:n])


def test_bundle_rejects_an_empty_request(bundle):
    server = serving.BundleServer(str(bundle[0]))
    with pytest.raises(ValueError, match="empty request"):
        server(np.zeros((0, N, 7), np.float32), np.zeros((0, N, 3), np.int32),
               np.zeros((0,), np.int32))


def test_bundle_poly_fallback_without_fixed_sizes(setup, bundle, tmp_path):
    """A bundle of the poly artifact alone (what export_bundle writes with no
    fixed batch) serves in chunks of its bound."""
    serving.save_bundle(str(tmp_path), {"poly": bundle[1]["poly"]}, setup["model"])
    server = serving.BundleServer(str(tmp_path))
    assert server.fixed_sizes == [] and server.has_poly
    assert server.poly_max == serving.poly_max_batch(setup["model"])
    with torch.no_grad():
        want = _direct(setup)(*_args(setup, slice(0, 3)))
    _assert_equal(server(*_args(setup, slice(0, 3))), want)
    server.poly_max = 2  # chunks of 2 and 1: the rows of other batches
    got = server(*_args(setup, slice(0, 3)))
    assert got["rot_pred"].shape == (3, 3, 3)
    for k in ("rot_pred", "trans_pred", "conf"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=ATOL)
    assert torch.equal(got["overflow"], want["overflow"])


def test_bf16_artifact_matches_the_direct_bf16_serve(setup):
    model = _port_model(setup["variables"], dtype=torch.bfloat16)
    got = serving.load_serve(serving.export_serve(model, setup["bank"], B, N))(*_args(setup))
    assert got["trans_pred"].dtype == torch.bfloat16 and got["rot_pred"].dtype == torch.float32
    with torch.no_grad():
        _assert_equal(got, _direct(setup, model)(*_args(setup)))
