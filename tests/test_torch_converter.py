"""The port's reference .pth converter against the JAX package's.

The port's convert_reference_state_dict equals JAX's leaf for leaf (exact)
on the state dicts tests/test_converter.py builds from torch modules in the
reference's layout (heads, disengagers, backbone convs, the refiner's MLP)
and on the full stage-1 and refiner state dicts of
tests/test_converter_full.py; an unmapped key raises; a torch.save ->
load_torch_checkpoint round trip is exact, and a file that needs more than
tensors and containers is refused. The converted full trees bridge into
the port's DCLNet and Refiner with no key missing or left over, and
to_reference_state_dict (the inverse) gives the same keys and shapes.
Then the two conversion steps (converter, weights.py bridge) are shown to
compose to the right tensors by running the models: one randomised JAX
DCLNet, written out as a reference .pth, runs in the JAX package through
its converter and in the port through load_reference_weights, on one batch
(16^3 grid, N = 128, B = 2): the same poses within 1e-5, as
tests/test_torch_model.py holds the bridged models.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu.models import Refiner as JaxRefiner
from dcl_net_tpu.train.checkpoints import convert_reference_state_dict as jax_convert
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.models.refiner import Refiner
from dcl_net_tpu_torch.train.checkpoints import (
    convert_reference_state_dict, load_reference_weights, load_torch_checkpoint,
    to_reference_state_dict,
)
from dcl_net_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_converter import _randomize_bn, _torch_head, _TorchDisengageBlock
from tests.test_converter_full import _fake_reference_state_dict
from tests.test_torch_model import CAPS, GRID, KW, N, UNIT, _randomise

torch.set_num_threads(2)


def refiner_state_dict(rng):
    """The refiner's reference keys, as tests/test_converter_full.py builds them."""
    sd = {}
    for name, dim_in, dims in [("MLP_share", 259, [512, 512, 1024]),
                               ("regressor_rot2", 1024, [512, 128, 9]),
                               ("regressor_trans2", 1024, [512, 128, 3])]:
        seq, cin = 0, dim_in
        for li, cout in enumerate(dims):
            sd[f"{name}.layers.{seq}.weight"] = rng.randn(cout, cin, 1).astype(np.float32)
            sd[f"{name}.layers.{seq}.bias"] = rng.randn(cout).astype(np.float32)
            seq += 2 if (name == "MLP_share" or li < len(dims) - 1) else 1
            cin = cout
    return sd


def module_state_dicts(rng):
    """Reference-layout state dicts of torch modules (tests/test_converter.py)."""
    torch.manual_seed(0)
    neck = _torch_head(512, [512, 512, 1024], ["relu"] * 3, [True] * 3)
    rot = _torch_head(1024, [512, 128, 9], ["relu", "relu", "none"], [False] * 3)
    mlp = _torch_head(259, [512, 512, 1024], ["relu"] * 3, [False] * 3)
    dis = tnn.Sequential(_TorchDisengageBlock(480, 256), _TorchDisengageBlock(256, 64))
    with torch.no_grad():
        _randomize_bn(neck, rng)
        _randomize_bn(dis, rng)
    out = {}
    for prefix, mod in (("neck_fuser.layers.", neck), ("regressor_rot.layers.", rot),
                        ("MLP_share.layers.", mlp), ("disengage_Xc_m1.", dis)):
        out.update({prefix + k: v.numpy() for k, v in mod.state_dict().items()})
    out["backbone_inp.module1.0.layers.0.weight"] = rng.randn(3, 3, 3, 7, 16).astype(np.float32)
    out["module.backbone_tmp.module2.1.layers.0.weight"] = rng.randn(
        3, 3, 3, 32, 64).astype(np.float32)  # a DataParallel prefix
    return out


def assert_trees_identical(got, want, where=""):
    assert isinstance(got, dict) and set(got) == set(want), where
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_identical(got[k], want[k], f"{where}/{k}")
        else:
            w = np.asarray(want[k])
            assert isinstance(got[k], np.ndarray), f"{where}/{k}"
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, f"{where}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{where}/{k}")


@pytest.mark.parametrize("which", ["modules", "stage1", "refiner"])
def test_converter_matches_jax_leaf_for_leaf(which):
    rng = np.random.RandomState(0)
    sd = {"modules": module_state_dicts, "stage1": _fake_reference_state_dict,
          "refiner": refiner_state_dict}[which](rng)
    got = convert_reference_state_dict(sd)
    assert_trees_identical(got, jax.tree.map(np.asarray, jax_convert(sd)))
    if which == "modules":  # a Conv1d 1x1 becomes a Dense kernel [Cin, Cout]
        np.testing.assert_array_equal(got["params"]["neck_fuser"]["Dense_0"]["kernel"],
                                      sd["neck_fuser.layers.0.weight"][:, :, 0].T)
        assert "conv3" in got["params"]["backbone_tmp"]


@pytest.mark.parametrize("key", [
    "backbone_inp.module1.0.layers.0.bias",       # a leaf the conv has not
    "backbone_inp.module1.0.layers.1.momentum",   # nor the BN
    "backbone_inp.module1.0.extra.0.weight",       # not the backbone's pattern
    "disengage_Xc_p1.0.layers.2.weight",
    "point_head.layers.0.weight",                  # a module the model has not
])
def test_unmapped_keys_raise(key):
    with pytest.raises(KeyError):
        convert_reference_state_dict({key: np.zeros(4, np.float32)})
    with pytest.raises(KeyError):
        jax_convert({key: np.zeros(4, np.float32)})


@pytest.mark.parametrize("layout", ["model_state_dict", "state_dict", "flat"])
def test_torch_save_round_trip_is_exact(tmp_path, layout):
    sd = _fake_reference_state_dict(np.random.RandomState(1))
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    path = str(tmp_path / "ref.pth")
    torch.save(tensors if layout == "flat" else {layout: tensors, "epoch": 350}, path)
    got = load_torch_checkpoint(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_needing_more_than_tensors_is_refused(tmp_path):
    path = str(tmp_path / "unsafe.pth")
    torch.save({"state_dict": {"a": torch.ones(2)}, "meta": fractions.Fraction(1, 3)}, path)
    with pytest.raises(ValueError, match="unsafe.pth"):
        load_torch_checkpoint(path)


def test_converted_trees_bridge_into_the_port():
    rng = np.random.RandomState(2)
    model = DCLNet(device="cpu", **KW)
    load_jax_variables(model, convert_reference_state_dict(_fake_reference_state_dict(rng)))
    refiner = Refiner(n_inp=64, device="cpu")
    load_jax_variables(refiner, convert_reference_state_dict(refiner_state_dict(rng)))
    ref_keys = {k: np.shape(v) for k, v in _fake_reference_state_dict(rng).items()}
    assert {k: np.shape(v) for k, v in to_reference_state_dict(model).items()} == ref_keys
    assert {k: np.shape(v) for k, v in to_reference_state_dict(refiner).items()} == {
        k: np.shape(v) for k, v in refiner_state_dict(rng).items()}


@pytest.fixture(scope="module")
def reference_models(tmp_path_factory):
    """A randomised JAX DCLNet and Refiner, written as reference .pth files
    through the port's exporter."""
    ds = SyntheticPoseDataset(n_objects=2, n_points=N, unit_voxel_extent=UNIT,
                              voxel_num_limit=GRID, seed=0)
    batch = make_batch([ds[i] for i in range(2)]).to_dict()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, **KW)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, b: jmodel.init(k, b, train=False))(
        jax.random.PRNGKey(0), jbatch))
    variables = {c: _randomise(dict(variables[c]), np.random.RandomState(1))
                 for c in ("params", "batch_stats")}
    exporter = load_jax_variables(DCLNet(device="cpu", **KW), variables)
    tmp = tmp_path_factory.mktemp("pth")
    path = str(tmp / "stage1.pth")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in
                                     to_reference_state_dict(exporter).items()}}, path)
    refiner = Refiner(n_inp=N, device="cpu", seed=3)
    refiner_path = str(tmp / "refiner.pth")
    torch.save({k: torch.from_numpy(v) for k, v in to_reference_state_dict(refiner).items()},
               refiner_path)
    return {"jmodel": jmodel, "variables": variables, "batch": batch, "jbatch": jbatch,
            "path": path, "refiner": refiner, "refiner_path": refiner_path}


def test_reference_pth_gives_the_jax_poses(reference_models):
    m = reference_models
    converted = jax_convert(load_torch_checkpoint(m["path"]))
    # the exporter is the converter's inverse: JAX's converter gives back the tree
    assert_trees_identical(jax.tree.map(np.asarray, converted), m["variables"])
    want = jax.jit(lambda v, b: m["jmodel"].apply(v, b, train=False))(converted, m["jbatch"])
    port = load_reference_weights(DCLNet(device="cpu", seed=5, **KW), m["path"])
    with torch.no_grad():
        got = port(batch_to_torch(m["batch"], "cpu"))
    for key in ("rot_pred", "trans_pred"):
        assert np.isfinite(np.asarray(want[key])).all()
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_reference_refiner_pth_matches_jax(reference_models):
    m = reference_models
    converted = jax_convert(load_torch_checkpoint(m["refiner_path"]))
    port = load_reference_weights(Refiner(n_inp=N, device="cpu", seed=9), m["refiner_path"])
    assert_trees_identical(to_jax_variables(port), to_jax_variables(m["refiner"]))
    rng = np.random.RandomState(4)
    inputs = {"input_features": rng.randn(2, N, 259).astype(np.float32),
              "conf": rng.rand(2, 2 * N).astype(np.float32)}
    want = JaxRefiner(n_inp=N).apply(converted, jax.tree.map(jnp.asarray, inputs))
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in inputs.items()})
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
