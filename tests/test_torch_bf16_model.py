"""The port's DCLNet in bf16 (model.compute_dtype: bfloat16) against the JAX
package's production bf16 variant, DCLNet(dtype=bfloat16,
voxelize_impl="matmul") on the same interp_mode ("pallas" or
"pallas_fused", its Pallas kernels in interpret mode), on bridged
PRNGKey(0) weights and the inputs of the JAX package's bf16 drift test
(tests/test_model.py::test_bf16_compute_pose_drift_bounded: 16^3 grid, 128
points, batch 4, SyntheticPoseDataset(seed=5)).

Two JAX bf16 implementations that round at other places (exact interp and
scatter voxelize against the Pallas kernels) are 4.3e-3 to 5.3e-3 apart in
relative L2 on the four disengage outputs of a branch, and 0.75 degrees
apart in pose. The port takes the Pallas variant's rounding points (K1's
bf16 sums, the three-pass window sum, XLA's bf16 sigmoid and softmax
steps), so its features must sit well inside that: FEAT_REL_L2 (measured
3.3e-4 to 6.7e-4; what is left is the order of the f32 sums inside the
matmuls and convolutions). Poses within the JAX drift bound, rotation
< 1 degree and translation < 0.5 mm, against JAX bf16 and against the
port's own f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.data.schema import make_batch as jax_make_batch
from dcl_net_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.weights import load_jax_variables

torch.set_num_threads(2)

GRID, UNIT, N = (16, 16, 16), (0.024, 0.024, 0.024), 128
CAPS = (256, 64, 16, 8)
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=CAPS)
MODES = ("pallas", "pallas_fused")
BRANCHES = (("encode_observed", "Xc"), ("encode_template", "Yo"))
HEADS = ("p1", "m1", "p2", "m2")
FEAT_REL_L2 = 3e-3
ROT_DEG, TRANS_MM = 1.0, 0.5


def pose_drift(rot_a, trans_a, rot_b, trans_b):
    """Per sample: the angle between two rotations in degrees and the
    distance between two translations in mm (both computed in f64)."""
    ra, rb = (np.asarray(r, np.float64) for r in (rot_a, rot_b))
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), exact for small angles
    chord = np.linalg.norm(ra - rb, axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    ta, tb = (np.asarray(t, np.float64) for t in (trans_a, trans_b))
    return (np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))),
            np.linalg.norm(ta - tb, axis=1) * 1000.0)


def as_f64(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def rel_l2(a, b) -> float:
    a, b = as_f64(a), as_f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def runs():
    ds = JaxSynthetic(n_objects=2, n_points=N, unit_voxel_extent=UNIT, voxel_num_limit=GRID,
                      seed=5)
    batch = jax_make_batch([ds[i] for i in range(4)]).to_dict()
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = batch_to_torch(batch, "cpu")
    variables = None
    out = {}
    for mode in MODES:
        jm = JaxDCLNet(n_inp=N, n_tmp=N, dtype=jnp.bfloat16, interp_mode=mode,
                       voxelize_impl="matmul", **KW)
        if variables is None:  # the parameter tree does not depend on the mode
            variables = jax.tree.map(np.asarray, jax.jit(
                lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(0), jbatch))

        def forward(v, b, jm=jm):
            obs = jm.apply(v, b, train=False, method=jm.encode_observed)
            tmp = jm.apply(v, b, train=False, method=jm.encode_template)
            return obs, tmp, jm.apply(v, obs, tmp, train=False, method=jm.fuse)

        jax_out = jax.tree.map(np.asarray, jax.jit(forward)(variables, jbatch))
        port_out = {}
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            tm = load_jax_variables(DCLNet(interp_mode=mode, device="cpu", dtype=dtype, **KW),
                                    variables)
            with torch.inference_mode():
                obs, tmp = tm.encode_observed(tbatch), tm.encode_template(tbatch)
                port_out[name] = (obs, tmp, tm.fuse(obs, tmp))
        out[mode] = (jax_out, port_out)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_bf16_disengage_outputs_match_jax_bf16(runs, mode):
    jax_out, port_out = runs[mode]
    for i, (_, side) in enumerate(BRANCHES):
        for head in HEADS:
            want, got = jax_out[i][head], port_out["bf16"][i][head]
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            err = rel_l2(want, got)
            assert err <= FEAT_REL_L2, f"{side} {head}: relative L2 {err:.3g}"


@pytest.mark.parametrize("mode", MODES)
def test_bf16_pose_matches_jax_bf16(runs, mode):
    jax_out, port_out = runs[mode]
    want, got = jax_out[2], port_out["bf16"][2]
    # the output types of the JAX model: the pose head's rotation is
    # projected in f32, the rest stays in the compute type
    for key in ("rot_pred", "trans_pred", "F_Xo_p", "conf", "Xo_pred", "Yc_pred",
                "points_inp"):
        assert str(got[key].dtype).replace("torch.", "") == str(want[key].dtype), key
    rot, trans = pose_drift(want["rot_pred"], as_f64(want["trans_pred"]),
                            as_f64(got["rot_pred"]), as_f64(got["trans_pred"]))
    assert rot.max() < ROT_DEG and trans.max() < TRANS_MM, (rot, trans)
    assert rel_l2(want["F_Xo_p"], got["F_Xo_p"]) <= FEAT_REL_L2
    np.testing.assert_array_equal(got["overflow"].numpy(), want["overflow"])


@pytest.mark.parametrize("mode", MODES)
def test_bf16_drift_from_the_ports_f32(runs, mode):
    _, port_out = runs[mode]
    a, b = port_out["f32"][2], port_out["bf16"][2]
    rot, trans = pose_drift(as_f64(a["rot_pred"]), as_f64(a["trans_pred"]),
                            as_f64(b["rot_pred"]), as_f64(b["trans_pred"]))
    assert rot.max() < ROT_DEG and trans.max() < TRANS_MM, (rot, trans)
    assert rot.max() > 0  # bf16 did run


def test_bf16_paths_agree(runs):
    """The fused path's bf16 K6 equals K2 -> centers -> K3 in bf16, so the
    two point-feature paths give the same model outputs."""
    a, b = runs["pallas"][1]["bf16"], runs["pallas_fused"][1]["bf16"]
    for key in ("rot_pred", "trans_pred", "F_Xo_p", "conf"):
        assert torch.equal(a[2][key], b[2][key]), key


@pytest.mark.parametrize("name, dtype", [(None, None), ("float32", None),
                                         ("bfloat16", torch.bfloat16)])
def test_build_model_reads_compute_dtype(name, dtype):
    overrides = ["model.n_inp=128", "model.n_tmp=128",
                 "model.unit_voxel_extent=[0.024,0.024,0.024]",
                 "model.voxel_num_limit=[16,16,16]", "model.interp_mode=pallas"]
    if name is not None:
        overrides.append(f"model.compute_dtype={name}")
    cfg = Config.fromfile("configs/config_YCBV_bs32.yaml").apply_overrides(overrides)
    model = build_model(cfg, device="cpu")
    assert model.dtype == dtype
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_build_model_refuses_another_compute_dtype():
    cfg = Config.fromfile("configs/config_YCBV_bs32.yaml").apply_overrides(
        ["model.compute_dtype=float16"])
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(cfg, device="cpu")
