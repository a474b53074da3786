"""K1's backward: the gradient of dclx::voxelize (voxelize_cuda) with
respect to the features, against the JAX package's pallas_voxelize VJP
(dcl_net_tpu/ops/pallas_voxelize.py:170-200), run as tests/test_ops.py runs
it on the CPU (interpret mode).

Both take the voxel's cotangent in f32, divide it by max(count, 1) in mode
4, multiply it by the point mask and cast it to the features' type; the
counts are exact, so the two gradients are equal. Modes 3 and 4, with and
without a mask, f32 and bf16 grids, on a 16^3 grid with in-grid points;
points outside the grid, which the port's forward drops, get zero; and
torch.library.opcheck of the op with features that require a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.ops.pallas_voxelize import pallas_voxelize
from dcl_net_tpu_torch.ops import cuda_voxelize

torch.set_num_threads(2)

GRID = (16, 16, 16)
B, N, C = 2, 96, 7
CASES = [(mode, masked, out) for mode in (3, 4) for masked in (False, True)
         for out in ("f32", "bf16")]
IDS = [f"mode{m}-{'mask' if k else 'nomask'}-{o}" for m, k, o in CASES]


def _inputs(seed: int, masked: bool, out: str):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, C).astype(np.float32)
    # few cells, so that voxels hold several points and mode 4 divides
    idx = rng.randint(3, 7, size=(B, N, 3)).astype(np.int32)
    mask = (rng.rand(B, N) > 0.3).astype(np.float32) if masked else None
    g = rng.randn(B, *GRID, C).astype(np.float32)
    if out == "bf16":  # the cotangent of a bf16 grid is bf16
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    return feats, idx, mask, g


@pytest.mark.parametrize("mode, masked, out", CASES, ids=IDS)
def test_gradient_equals_the_jax_vjp(mode, masked, out):
    feats, idx, mask, g = _inputs(mode * 10 + masked, masked, out)
    jdt, tdt = (None, None) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda f: pallas_voxelize(f, jnp.asarray(idx), GRID, mode=mode,
                                               point_mask=jmask, out_dtype=jdt)[0],
                     jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g).astype(jdt or jnp.float32))

    tf = torch.from_numpy(feats).requires_grad_(True)
    grid, count = cuda_voxelize.voxelize_cuda(
        tf, torch.from_numpy(idx), GRID, mode,
        None if mask is None else torch.from_numpy(mask), tdt)
    (got,) = torch.autograd.grad(grid, tf, torch.from_numpy(g).to(grid.dtype))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mask is not None:  # a masked point gets nothing
        assert not got.numpy()[mask == 0].any()


def test_points_outside_the_grid_get_zero():
    feats, idx, _, g = _inputs(5, False, "f32")
    idx[0, :10, 1] = GRID[1]  # out of range on one axis: dropped by the forward
    idx[1, :5, 2] = -1
    tf = torch.from_numpy(feats).requires_grad_(True)
    ti = torch.from_numpy(idx)
    grid, _ = cuda_voxelize.voxelize_cuda(tf, ti, GRID, 4)
    (got,) = torch.autograd.grad(grid, tf, torch.from_numpy(g))
    assert not got[0, :10].any() and not got[1, :5].any()
    assert got[0, 10:].abs().sum() > 0
    # the in-grid points' gradient is the gradient with the others left out
    keep = torch.ones(B, N, dtype=torch.bool)
    keep[0, :10] = keep[1, :5] = False
    mask = keep.float()
    tf2 = torch.from_numpy(feats).requires_grad_(True)
    grid2, _ = cuda_voxelize.voxelize_cuda(tf2, torch.where(keep[..., None], ti, 0), GRID, 4,
                                           mask)
    (want,) = torch.autograd.grad(grid2, tf2, torch.from_numpy(g))
    assert torch.equal(got, want)


@pytest.mark.parametrize("out", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_opcheck_with_gradient(out):
    feats, idx, mask, _ = _inputs(7, True, "f32")
    args = (torch.from_numpy(feats).requires_grad_(True), torch.from_numpy(idx),
            list(GRID), 4, torch.from_numpy(mask), out)
    torch.library.opcheck(torch.ops.dclx.voxelize.default, args)
    # and the gradient reaches the features through the op
    grid, count = torch.ops.dclx.voxelize(*args)
    (d,) = torch.autograd.grad(grid.float().sum(), args[0])
    assert d.shape == args[0].shape and d.abs().sum() > 0
