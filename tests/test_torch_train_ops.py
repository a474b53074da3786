"""The backward kernels' plain versions (K4, K5) and their autograd Functions
against the JAX package's custom VJPs, on the same numpy inputs.

K4 (interpolation backward) is held to jax.vjp of the Pallas interpolation
(interpret mode, as the JAX tests run it) and of the XLA 3-NN path; K5
(compaction backward) to jax.vjp of the XLA dense_to_sparse, whose slot
order the port shares bit for bit. The Pallas compaction puts its slots
elsewhere (8-aligned chunks), so it is compared through a layout-free
composite: the grid gradient of compaction followed by interpolation.
Small shapes: 8^3 and 4^3 grids, N = 128 (the Pallas interpolation needs
N % 128 == 0).
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dcl_net_tpu.ops.knn  # noqa: F401
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu.ops.pallas_compact import pallas_dense_to_sparse
from dcl_net_tpu.ops.pallas_interp import pallas_nn_interpolate
from dcl_net_tpu_torch.ops import cuda_compact, cuda_interp
from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers
from tests.test_torch_train_model import N

# dcl_net_tpu.ops re-exports a function named knn over its module
jknn = sys.modules["dcl_net_tpu.ops.knn"]

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _interp_inputs(rng, v=256, c=8):
    b = 3
    pts = ((rng.rand(b, N, 3) - 0.5) * 0.3).astype(np.float32)
    ctr = ((rng.rand(b, v, 3) - 0.5) * 0.3).astype(np.float32)
    feats = rng.randn(b, v, c).astype(np.float32)
    mask = (rng.rand(b, v) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[1, [0, 77]] = 1.0  # two valid centers, one of them index 0
    mask[2] = 0.0
    mask[2, 130] = 1.0      # one valid center
    feats = feats * mask[..., None]
    g = rng.randn(b, N, c).astype(np.float32)
    return pts, ctr, feats, mask, g


def _port_interp_bwd(pts, ctr, feats, mask, g):
    _, w, idx = cuda_interp.nn_interpolate_cuda(_t(pts), _t(ctr), _t(feats), _t(mask))
    return cuda_interp.nn_interpolate_bwd_cuda(_t(g), w, idx, feats.shape[1]).numpy()


def test_interp_backward_plain_matches_pallas_vjp():
    pts, ctr, feats, mask, g = _interp_inputs(np.random.RandomState(21))
    got = _port_interp_bwd(pts, ctr, feats, mask, g)
    _, vjp = jax.vjp(lambda f: pallas_nn_interpolate(
        jnp.asarray(pts), jnp.asarray(ctr), f, jnp.asarray(mask)), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    # the same neighbours and weights; each row sums its w * g terms in
    # another order than the one-hot matmul: 1e-5 on sums of ~|g| * 5
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert cuda_interp.bwd_launches == 0  # CPU tensors never reach the kernel


def test_interp_backward_plain_matches_xla_vjp():
    pts, ctr, feats, mask, g = _interp_inputs(np.random.RandomState(22))
    got = _port_interp_bwd(pts, ctr, feats, mask, g)
    _, vjp = jax.vjp(lambda f: jknn.nearest_neighbor_interpolate(
        jnp.asarray(pts), jnp.asarray(ctr), f, jnp.asarray(mask)), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    # the XLA path's expansion-form distances move the weights by ~1e-6
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


def _occupied_grid(rng, occupancy, d=8, c=6):
    b = len(occupancy)
    feats = np.zeros((b, d, d, d, c), np.float32)
    mask = np.zeros((b, d, d, d), np.float32)
    for bi, n_occ in enumerate(occupancy):
        cells = rng.choice(d ** 3, n_occ, replace=False)
        idx = np.unravel_index(cells, (d, d, d))
        mask[(bi,) + idx] = 1.0
        feats[(bi,) + idx] = rng.randn(n_occ, c)
    return feats, mask


@pytest.mark.parametrize("cap", [64, 512])
def test_compaction_backward_plain_is_bit_equal_to_xla_vjp(cap):
    rng = np.random.RandomState(cap + 1)
    feats, mask = _occupied_grid(rng, occupancy=(40, 100))  # 100 > 64 overflows
    dv = rng.randn(2, cap, 6).astype(np.float32)
    coords, _, vmask, _ = cuda_compact.dense_to_sparse_cuda(_t(feats), _t(mask), cap)
    got = cuda_compact.dense_to_sparse_bwd_cuda(_t(dv), coords, vmask, (8, 8, 8))
    _, vjp = jax.vjp(lambda f: jsc.dense_to_sparse(f, jnp.asarray(mask), cap)[1],
                     jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(dv))
    # one copy per valid slot, zeros elsewhere: bit-equal
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # dropped voxels (past the capacity) get no gradient
    assert int((got.abs().sum(-1) > 0).sum()) == int(vmask.sum())
    assert cuda_compact.bwd_launches == 0


def test_compaction_then_interpolation_grid_gradient_matches_pallas():
    """Layout-free composite: d(interpolated features)/d(grid), through the
    Pallas compaction (8-aligned slots) and interpolation in JAX and through
    the port's two Functions."""
    rng = np.random.RandomState(23)
    feats, mask = _occupied_grid(rng, occupancy=(60, 140), d=8, c=6)
    unit, scale = (0.024,) * 3, 1.0
    offset = tuple(-0.5 * 0.024 * 8 for _ in range(3))
    pts = ((rng.rand(2, N, 3) - 0.5) * 0.19).astype(np.float32)
    g = rng.randn(2, N, 6).astype(np.float32)
    cap = 256  # room for the Pallas layout's gaps: no voxel is dropped

    def jf(grid):
        coords, vf, vm = pallas_dense_to_sparse(grid, jnp.asarray(mask), cap)
        ctr = jsc.voxel_centers(coords, unit, scale, offset)
        return pallas_nn_interpolate(jnp.asarray(pts), ctr, vf, vm)

    want_out, vjp = jax.vjp(jf, jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    grid = _t(feats).requires_grad_(True)
    coords, vf, vm, _ = cuda_compact.dense_to_sparse(grid, _t(mask), cap)
    out = cuda_interp.nn_interpolate(_t(pts), voxel_centers(coords, unit, scale, offset),
                                     vf, vm)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-6)
    # sums of up to a few dozen w * g terms per cell, in other orders
    np.testing.assert_allclose(grid.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert cuda_compact.bwd_launches == cuda_interp.bwd_launches == 0


def test_functions_pass_gradcheck_in_f64():
    rng = np.random.RandomState(24)
    feats, mask = _occupied_grid(rng, occupancy=(9, 20), d=4, c=3)
    grid = _t(feats.astype(np.float64)).requires_grad_(True)
    # capacity 12 < 20: the second sample overflows, its dropped cells get 0
    assert torch.autograd.gradcheck(
        lambda f: cuda_compact.dense_to_sparse(f, _t(mask), 12)[1], (grid,))
    pts = _t(rng.rand(2, 16, 3))
    ctr = _t(rng.rand(2, 10, 3))
    vmask = _t((rng.rand(2, 10) > 0.3).astype(np.float64))
    vfeats = _t(rng.randn(2, 10, 4)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda f: cuda_interp.nn_interpolate(pts, ctr, f, vmask), (vfeats,))


def test_backward_wrappers_refuse_non_cpu_tensors_without_the_kernel():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_interp.nn_interpolate_bwd_cuda(
            torch.empty(2, N, 4, **meta), torch.empty(2, 3, N, **meta),
            torch.empty(2, 3, N, dtype=torch.int32, **meta), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_compact.dense_to_sparse_bwd_cuda(
            torch.empty(2, 16, 4, **meta), torch.empty(2, 16, 3, dtype=torch.int32, **meta),
            torch.empty(2, 16, **meta), (8, 8, 8))
    assert cuda_interp.bwd_launches == cuda_compact.bwd_launches == 0
