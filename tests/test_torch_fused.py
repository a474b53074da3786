"""The fused compaction -> interpolation of the port (K6 forward, K7
backward; ops/cuda_fused.py) against the JAX package's, on the same numpy
inputs and, at model level, on bridged weights.

On the CPU the port runs the plain versions. The JAX fused op
(pallas_compact_interpolate) runs in interpret mode. Its compaction keeps
each 8-row chunk of the grid at an 8-aligned offset, so it drops voxels
already when the aligned layout is full (pallas_compact.capacity_overflow),
where the port drops exactly the occupied voxels past the capacity, in
index order, as the JAX exact path (dense_to_sparse) does. So the Pallas
path is compared only where capacity_overflow is False for every sample,
and the over-capacity case against the exact path. Only out and the
gradient are compared: the Pallas idx indexes the raw rows, gaps included.

Small shapes: 16^3 grid, C = 8, N = 128 (the JAX Pallas paths need
N % 128 == 0), capacity 256.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.models import DCLNet as JaxDCLNet
import dcl_net_tpu.ops.knn  # noqa: F401
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu.ops.pallas_compact import capacity_overflow
from dcl_net_tpu.ops.pallas_fused import pallas_compact_interpolate
from dcl_net_tpu.ops.pallas_interp import pallas_nn_interpolate
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine, voxel_centers
from dcl_net_tpu_torch.tools.common import build_model
from dcl_net_tpu_torch.weights import load_jax_variables
from tests.test_torch_model import _randomise
from tests.test_torch_train_model import (
    KW,
    LOSSES,
    N,
    as_f64,
    assert_grads_close,
    assert_stats_close,
    build_setup,
    jax_step,
    leaves,
    torch_step,
)
from tests.test_torch_train_ops import _occupied_grid, _t

# dcl_net_tpu.ops re-exports a function named knn over its module
jknn = sys.modules["dcl_net_tpu.ops.knn"]

torch.set_num_threads(2)

D, C, CAP = 16, 8, 256
UNIT, SCALE = (0.024,) * 3, 2.0
OFFSET = tuple(-0.5 * 0.024 * D * SCALE for _ in range(3))


def _inputs(seed, occupancy):
    rng = np.random.RandomState(seed)
    feats, mask = _occupied_grid(rng, occupancy=occupancy, d=D, c=C)
    pts = ((rng.rand(len(occupancy), N, 3) - 0.5) * 0.7).astype(np.float32)
    g = rng.randn(len(occupancy), N, C).astype(np.float32)
    return feats, mask, pts, g


def _port_fused(feats, mask, pts, cap=CAP):
    """(out, occupancy, grid) through the port's autograd Function; grid
    requires grad."""
    grid = _t(feats).requires_grad_(True)
    unit_s, off_c = voxel_center_affine(UNIT, SCALE, OFFSET)
    out, occ = cuda_fused.compact_interpolate(grid, _t(mask), _t(pts), cap, unit_s, off_c)
    return out, occ, grid


def _jax_fused(feats, mask, pts, cap=CAP):
    us = tuple(u * SCALE for u in UNIT)
    return lambda f: pallas_compact_interpolate(
        f, jnp.asarray(mask), jnp.asarray(pts), cap, us, OFFSET)


def test_fused_forward_matches_jax_pallas_without_capacity_overflow():
    feats, mask, pts, _ = _inputs(31, occupancy=(60, 150))
    assert not bool(capacity_overflow(jnp.asarray(mask), CAP).any())
    want = jax.jit(_jax_fused(feats, mask, pts))(jnp.asarray(feats))
    got, occ, _ = _port_fused(feats, mask, pts)
    # the same centers (f32 affine constants), distances and top 3; the
    # weighted sum rounds in another order than the one-hot matmul
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert occ.tolist() == [60, 150]
    assert cuda_fused.launches == cuda_compact.launches == 0  # no kernel on the CPU


def test_fused_over_capacity_matches_jax_exact_path():
    feats, mask, pts, _ = _inputs(32, occupancy=(100, 553))  # the second overflows
    assert bool(capacity_overflow(jnp.asarray(mask), CAP)[1])

    def exact(f, interp):
        coords, vf, vm = jsc.dense_to_sparse(f, jnp.asarray(mask), CAP)
        ctr = jsc.voxel_centers(coords, UNIT, SCALE, OFFSET)
        return interp(jnp.asarray(pts), ctr, vf, vm)

    got, occ, _ = _port_fused(feats, mask, pts)
    got = got.detach().numpy()
    assert (occ > CAP).tolist() == [False, True]
    # both keep the first 256 occupied voxels in index order. Through the
    # Pallas interpolation (direct-difference distances, as the port's):
    # sums in another order, 1e-5
    want = jax.jit(lambda f: exact(f, pallas_nn_interpolate))(jnp.asarray(feats))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    # through the exact path's 3-NN, whose expansion-form distances move the
    # weights by ~1e-6 relative (1.2e-5 on a few outputs here): 2e-5, as
    # tests/test_torch_train_ops.py holds the plain K4 to the XLA path
    want = jax.jit(lambda f: exact(f, jknn.nearest_neighbor_interpolate))(jnp.asarray(feats))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


def test_fused_feature_gradient_matches_jax_pallas():
    feats, mask, pts, g = _inputs(33, occupancy=(80, 120))
    assert not bool(capacity_overflow(jnp.asarray(mask), CAP).any())
    fn = _jax_fused(feats, mask, pts)
    want = jax.jit(jax.grad(lambda f: jnp.sum(fn(f) * g)))(jnp.asarray(feats))
    out, _, grid = _port_fused(feats, mask, pts)
    (out * _t(g)).sum().backward()
    # each occupied cell sums its w * g terms in another order than the
    # transposed one-hot matmul: 1e-5 on sums of ~|g| * 5
    np.testing.assert_allclose(grid.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert cuda_fused.bwd_launches == 0


@pytest.mark.parametrize("occupancy", [(60, 150), (100, 553)], ids=["fits", "overflows"])
def test_fused_is_bit_equal_to_the_two_stage_path(occupancy):
    feats, mask, pts, g = _inputs(34, occupancy=occupancy)
    out, occ, grid = _port_fused(feats, mask, pts)
    (out * _t(g)).sum().backward()

    two = _t(feats).requires_grad_(True)
    coords, vf, vm, occ2 = cuda_compact.dense_to_sparse(two, _t(mask), CAP)
    ref = cuda_interp.nn_interpolate(_t(pts), voxel_centers(coords, UNIT, SCALE, OFFSET),
                                     vf, vm)
    (ref * _t(g)).sum().backward()
    assert torch.equal(out, ref)
    assert torch.equal(occ, occ2)
    assert torch.equal(grid.grad, two.grad)
    # and the plain K6 gives K3's w and idx
    unit_s, off_c = voxel_center_affine(UNIT, SCALE, OFFSET)
    got = cuda_fused.compact_interpolate_cuda(_t(pts), coords, vf.detach(), vm, occ2,
                                              unit_s, off_c)
    want = cuda_interp.nn_interpolate_cuda(
        _t(pts), voxel_centers(coords, UNIT, SCALE, OFFSET), vf.detach(), vm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_wrappers_refuse_non_cpu_tensors_without_the_kernel():
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fused.compact_interpolate_cuda(
            torch.empty(2, N, 3, **meta), torch.empty(2, 16, 3, **i32),
            torch.empty(2, 16, 4, **meta), torch.empty(2, 16, **meta),
            torch.empty(2, **i32), (0.1,) * 3, (0.0,) * 3)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fused.compact_interpolate_bwd_cuda(
            torch.empty(2, N, 4, **meta), torch.empty(2, 3, N, **meta),
            torch.empty(2, 3, N, **i32), torch.empty(2, 16, 3, **i32),
            torch.empty(2, 16, **meta), (8, 8, 8))


def test_model_level_fused_matches_jax_fused():
    """DCLNet(interp_mode="pallas_fused") on bridged weights against the JAX
    DCLNet(interp_mode="pallas_fused") (tests/test_pallas_fused.py)."""
    ds = SyntheticPoseDataset(n_objects=2, n_points=N, unit_voxel_extent=KW["unit_voxel_extent"],
                              voxel_num_limit=KW["voxel_num_limit"], seed=0)
    batch = make_batch([ds[i] for i in range(2)]).to_dict()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jmodel = JaxDCLNet(interp_mode="pallas_fused", n_inp=N, n_tmp=N, **KW)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, b: jmodel.init(k, b, train=False))(jax.random.PRNGKey(0), jbatch))
    variables = {c: _randomise(dict(variables[c]), np.random.RandomState(1))
                 for c in ("params", "batch_stats")}
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, jbatch)
    assert not np.asarray(want["overflow"]).any()  # no Pallas layout overflow
    tmodel = load_jax_variables(DCLNet(interp_mode="pallas_fused", device="cpu", **KW),
                                variables)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    # f32 on both sides, the same 3-NN arithmetic: 1e-5 through the network
    for key in ("rot_pred", "trans_pred", "conf", "Xo_pred", "Yc_pred"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["overflow"].numpy(), np.asarray(want["overflow"]))


def test_fused_train_step_gradients_match_jax_f64():
    """One train step of the fused model against jax.value_and_grad in f64:
    within test_torch_train_model.py's 1e-4 of each leaf's scale of the
    JAX exact path, and as close to the JAX fused path (its kernels compute
    in f32 inside the f64 model) as the JAX exact path itself is."""
    jexact, variables, batch, _ = build_setup()
    jfused = JaxDCLNet(interp_mode="pallas_fused", n_inp=N, n_tmp=N, **KW)
    v64, b64 = as_f64(variables), as_f64(batch)
    with jax.enable_x64(True):
        want, want_grads, want_stats = jax_step(jfused, v64, b64)
        exact, exact_grads, _ = jax_step(jexact, v64, b64)
    got, got_grads, got_stats = torch_step(v64, batch, torch.float64,
                                           interp_mode="pallas_fused")
    for k in LOSSES:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k], float(exact[k]), rtol=1e-5, err_msg=k)
    assert_stats_close(got_stats, want_stats, 1e-5)
    assert_grads_close(got_grads, exact_grads, rel=1e-4)
    got, want, exact = (dict(leaves(t)) for t in (got_grads, want_grads, exact_grads))
    for path in want:
        scale = np.abs(want[path]).max()
        own = np.abs(exact[path] - want[path]).max()
        err = np.abs(got[path] - want[path]).max()
        assert err <= 2 * own + 1e-4 * scale, f"{'/'.join(path)}: {err} vs {own}"


def test_build_model_takes_the_fused_mode_and_refuses_local():
    cfg = Config.fromfile("configs/config_synthetic_smoke.yaml").apply_overrides([
        "model.voxel_num_limit=[16,16,16]", "model.unit_voxel_extent=[0.024,0.024,0.024]"])
    assert build_model(cfg, device="cpu").point_feats_inp.interp_mode == "exact"
    fused = build_model(cfg.apply_overrides(["model.interp_mode=pallas_fused"]), device="cpu")
    assert {fused.point_feats_inp.interp_mode, fused.point_feats_tmp.interp_mode} == {
        "pallas_fused"}
    over = cfg.apply_overrides(["model.interp_mode=pallas"])
    assert build_model(over, device="cpu").point_feats_inp.interp_mode == "pallas"
    with pytest.raises(NotImplementedError, match="local"):
        build_model(cfg.apply_overrides(["model.interp_mode=local"]), device="cpu")
    with pytest.raises(ValueError, match="interp_mode"):
        DCLNet(interp_mode="nearest", device="cpu")
