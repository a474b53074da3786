"""The plain versions of the bf16 backward kernels (K4, K5, K7 under
model.compute_dtype: bfloat16) against the VJPs of the JAX package's Pallas
functions with bf16 features, run as the JAX tests run them on the CPU
(interpret mode), and their autograd Functions.

The JAX backwards widen the bf16 cotangent to f32, sum in f32 and cast the
result to bf16 once (pallas_interp._vjp_bwd, pallas_fused._vjp_bwd), or
copy bf16 rows (pallas_compact._run_bwd). The port's plain versions take
the same steps, so:
- K5 is bit-equal to the JAX compaction's VJP;
- K4 and K7 are within one bf16 ulp of it (the one-hot matmul sums each
  row in another order than the port's entry order, so a sum near a
  rounding boundary can round the other way);
- each is bit-equal to its f32 plain version on the widened cotangent,
  rounded to bf16 once.
Small shapes: 16^3 and 8^3 grids, N = 128 (the Pallas interpolation needs
N % 128 == 0).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.ops import pallas_fused
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu.ops.pallas_compact import capacity_overflow, pallas_dense_to_sparse
from dcl_net_tpu.ops.pallas_interp import pallas_nn_interpolate
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine
from tests.test_torch_bf16_ops import bf16_bits, ulps
from tests.test_torch_train_ops import _occupied_grid

torch.set_num_threads(2)

BF16 = torch.bfloat16
N = 128
D, SCALE = 16, 2.0
UNIT = (0.024,) * 3
OFFSET = tuple(-0.5 * 0.024 * D * SCALE for _ in range(3))


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_torch_bf16(x) -> torch.Tensor:
    """A bf16 JAX array as the bf16 torch tensor of the same bits."""
    return _t(np.asarray(jnp.asarray(x).astype(jnp.float32))).to(BF16)


def _bf16(rng, *shape, scale=1.0):
    """Random bf16 values as a JAX array."""
    return jnp.asarray((rng.randn(*shape) * scale).astype(np.float32)).astype(jnp.bfloat16)


def _interp_inputs(seed, b=3, v=100, c=16):
    """Points, centers, bf16 features, a mask (one sample with two valid
    centers, one of them index 0) and a bf16 cotangent of mixed magnitude."""
    rng = np.random.RandomState(seed)
    pts = ((rng.rand(b, N, 3) - 0.5) * 0.4).astype(np.float32)
    ctr = ((rng.rand(b, v, 3) - 0.5) * 0.4).astype(np.float32)
    mask = (rng.rand(b, v) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[1, [0, 57]] = 1.0
    feats = _bf16(rng, b, v, c)
    g = jnp.asarray((rng.randn(b, N, c) * 10.0 ** rng.randint(-2, 3, size=(b, N, 1)))
                    .astype(np.float32)).astype(jnp.bfloat16)
    return pts, ctr, feats, mask, g


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k4_bf16_matches_pallas_interp_vjp(seed):
    pts, ctr, feats, mask, g = _interp_inputs(seed)
    _, vjp = jax.vjp(lambda f: pallas_nn_interpolate(
        jnp.asarray(pts), jnp.asarray(ctr), f, jnp.asarray(mask)), feats)
    (want,) = jax.jit(vjp)(g)
    assert want.dtype == jnp.bfloat16
    _, w, idx = cuda_interp.nn_interpolate_cuda(_t(pts), _t(ctr), _to_torch_bf16(feats),
                                                _t(mask))
    tg = _to_torch_bf16(g)
    got = cuda_interp.nn_interpolate_bwd_cuda(tg, w, idx, feats.shape[1])
    assert got.dtype == BF16
    assert ulps(got, want).max() <= 1
    # the f32 plain version on the widened cotangent, rounded once
    f32 = cuda_interp.nn_interpolate_bwd_cuda(tg.float(), w, idx, feats.shape[1])
    assert f32.dtype == torch.float32 and torch.equal(got, f32.to(BF16))
    assert cuda_interp.bwd_launches == cuda_interp.bwd_launches_bf16 == 0


@pytest.mark.parametrize("cap", [64, 512])  # 100 > 64: the second sample overflows
def test_plain_k5_bf16_is_bit_equal_to_xla_vjp(cap):
    rng = np.random.RandomState(cap)
    feats, mask = _occupied_grid(rng, occupancy=(40, 100), d=8, c=16)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    dv = _bf16(rng, 2, cap, 16)
    _, vjp = jax.vjp(lambda f: jsc.dense_to_sparse(f, jnp.asarray(mask), cap)[1], fb)
    (want,) = vjp(dv)
    coords, _, vmask, _ = cuda_compact.dense_to_sparse_cuda(_to_torch_bf16(fb), _t(mask), cap)
    got = cuda_compact.dense_to_sparse_bwd_cuda(_to_torch_bf16(dv), coords, vmask, (8, 8, 8))
    assert got.dtype == BF16
    np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))
    # a copy: the f32 plain version of the widened rows, rounded, is the same
    f32 = cuda_compact.dense_to_sparse_bwd_cuda(_to_torch_bf16(dv).float(), coords, vmask,
                                                (8, 8, 8))
    assert torch.equal(got, f32.to(BF16))
    assert int((got.float().abs().sum(-1) > 0).sum()) == int(vmask.sum())
    assert cuda_compact.bwd_launches == cuda_compact.bwd_launches_bf16 == 0


@pytest.mark.parametrize("occupancy", [(40, 130), (3, 200)])
def test_plain_k5_bf16_is_bit_equal_to_pallas_compaction_vjp(occupancy):
    """The Pallas compaction leaves 8-aligned gaps between chunks, so each
    side gets the cotangent of one random bf16 grid read at its own slots:
    both VJPs give that grid back on the occupied cells, bit for bit."""
    rng = np.random.RandomState(sum(occupancy))
    cap, c = 512, 8
    feats, mask = _occupied_grid(rng, occupancy=occupancy, d=D, c=c)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    assert not bool(capacity_overflow(jnp.asarray(mask), cap).any())
    cot = np.asarray(_bf16(rng, len(occupancy), D, D, D, c).astype(jnp.float32))

    def at_slots(coords, vmask):
        xyz = np.asarray(coords).astype(np.int64)
        rows = cot[np.arange(len(occupancy))[:, None], xyz[..., 0], xyz[..., 1], xyz[..., 2]]
        return rows * (np.asarray(vmask) > 0)[..., None]

    jc, _, jm = pallas_dense_to_sparse(fb, jnp.asarray(mask), cap)
    _, vjp = jax.vjp(lambda f: pallas_dense_to_sparse(f, jnp.asarray(mask), cap)[1], fb)
    (want,) = vjp(jnp.asarray(at_slots(jc, jm)).astype(jnp.bfloat16))
    coords, _, vmask, _ = cuda_compact.dense_to_sparse_cuda(_to_torch_bf16(fb), _t(mask), cap)
    dv = _t(at_slots(coords.numpy(), vmask.numpy()).astype(np.float32)).to(BF16)
    got = cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, (D, D, D))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))
    np.testing.assert_array_equal(got.float().numpy(), cot * mask[..., None])


def _fused_inputs(occupancy, seed):
    rng = np.random.RandomState(seed)
    feats, mask = _occupied_grid(rng, occupancy=occupancy, d=D, c=8)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    pts = ((rng.rand(len(occupancy), N, 3) - 0.5) * 0.7).astype(np.float32)
    g = _bf16(rng, len(occupancy), N, 8, scale=3.0)
    return fb, mask, pts, g


@pytest.mark.parametrize("occupancy", [(60, 150), (3, 240)])
def test_plain_k7_bf16_matches_pallas_fused_vjp(occupancy):
    fb, mask, pts, g = _fused_inputs(occupancy, seed=sum(occupancy))
    cap = 256
    assert not bool(capacity_overflow(jnp.asarray(mask), cap).any())

    def fused(f):
        return pallas_fused.pallas_compact_interpolate(f, jnp.asarray(mask), jnp.asarray(pts),
                                                       cap, tuple(u * SCALE for u in UNIT),
                                                       OFFSET)

    _, vjp = jax.vjp(fused, fb)
    (want,) = jax.jit(vjp)(g)
    assert want.dtype == jnp.bfloat16
    unit_s, off_c = (tuple(map(float, a)) for a in voxel_center_affine(UNIT, SCALE, OFFSET))
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(_to_torch_bf16(fb),
                                                                   _t(mask), cap)
    _, w, idx = cuda_fused.compact_interpolate_cuda(_t(pts), coords, vfeats, vmask, occ,
                                                    unit_s, off_c)
    tg = _to_torch_bf16(g)
    got = cuda_fused.compact_interpolate_bwd_cuda(tg, w, idx, coords, vmask, (D, D, D))
    assert got.dtype == BF16
    assert ulps(got, want).max() <= 1
    # K4's f32 sums rounded once, then K5's copy: the f32 plain K7, rounded
    f32 = cuda_fused.compact_interpolate_bwd_cuda(tg.float(), w, idx, coords, vmask,
                                                  (D, D, D))
    assert torch.equal(got, f32.to(BF16))
    # and K7 is K4 then K5, in bf16
    two = cuda_compact.dense_to_sparse_bwd_cuda(
        cuda_interp.nn_interpolate_bwd_cuda(tg, w, idx, cap), coords, vmask, (D, D, D))
    assert torch.equal(got, two)
    assert cuda_fused.bwd_launches == cuda_fused.bwd_launches_bf16 == 0


def test_functions_give_bf16_gradients_to_bf16_features():
    """Each autograd Function hands back the features' gradient in their
    type, as its backward wrapper makes it (no silent cast by the engine),
    and equal to the wrapper's own result."""
    fb, mask, pts, g = _fused_inputs((60, 150), seed=5)
    cap = 256
    unit_s, off_c = (tuple(map(float, a)) for a in voxel_center_affine(UNIT, SCALE, OFFSET))
    tg = _to_torch_bf16(g)

    grid = _to_torch_bf16(fb).requires_grad_(True)
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse(grid, _t(mask), cap)
    vfeats.retain_grad()
    centers = (coords.float() * torch.tensor(unit_s) + torch.tensor(off_c))
    out = cuda_interp.nn_interpolate(_t(pts), centers, vfeats, vmask, occ)
    assert out.dtype == BF16
    out.backward(tg)
    assert vfeats.grad.dtype == BF16 and grid.grad.dtype == BF16
    _, w, idx = cuda_interp.nn_interpolate_cuda(_t(pts), centers, vfeats.detach(), vmask, occ)
    assert torch.equal(vfeats.grad, cuda_interp.nn_interpolate_bwd_cuda(tg, w, idx, cap))
    assert torch.equal(grid.grad, cuda_compact.dense_to_sparse_bwd_cuda(
        vfeats.grad, coords, vmask, (D, D, D)))

    fused_grid = _to_torch_bf16(fb).requires_grad_(True)
    out2, _ = cuda_fused.compact_interpolate(fused_grid, _t(mask), _t(pts), cap, unit_s, off_c)
    assert torch.equal(out2, out.detach())
    out2.backward(tg)
    assert fused_grid.grad.dtype == BF16
    # the fused path's K7 equals the two-stage path's K4 then K5
    assert torch.equal(fused_grid.grad, grid.grad)
    assert (cuda_interp.bwd_launches_bf16 == cuda_compact.bwd_launches_bf16
            == cuda_fused.bwd_launches_bf16 == 0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_backward_wrappers_check_the_cotangent_type_on_the_card(dtype):
    """On a CUDA-less device the wrappers reach their device check with an
    f32 or a bf16 cotangent: both types are taken (the launch is what the
    card runs), and no kernel is launched."""
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_interp.nn_interpolate_bwd_cuda(torch.empty(2, N, 4, dtype=dtype, **meta),
                                            torch.empty(2, 3, N, **meta),
                                            torch.empty(2, 3, N, **i32), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_compact.dense_to_sparse_bwd_cuda(torch.empty(2, 16, 4, dtype=dtype, **meta),
                                              torch.empty(2, 16, 3, **i32),
                                              torch.empty(2, 16, **meta), (8, 8, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fused.compact_interpolate_bwd_cuda(
            torch.empty(2, N, 4, dtype=dtype, **meta), torch.empty(2, 3, N, **meta),
            torch.empty(2, 3, N, **i32), torch.empty(2, 16, 3, **i32),
            torch.empty(2, 16, **meta), (8, 8, 8))
    assert cuda_interp.bwd_launches_bf16 == cuda_compact.bwd_launches_bf16 == 0
    assert cuda_fused.bwd_launches_bf16 == 0


@pytest.mark.parametrize("c, f32_cells", [(32, 128), (64, 64), (256, 16)])
def test_bf16_grid_tiles_hold_the_same_bytes(c, f32_cells):
    """K5's and K7's bf16 variants tile the grid in bytes: twice the cells
    of the f32 variant's tile, about BWD_TILE_BYTES each."""
    assert cuda_compact.bwd_tile(c) == f32_cells
    assert cuda_compact.bwd_tile(c, 2) == 2 * f32_cells
    assert cuda_compact.bwd_tile(c, 2) * c * 2 == cuda_compact.BWD_TILE_BYTES
    # K7 takes K5's tile where the grid has cells enough for 2048 blocks
    assert cuda_fused.bwd_tile(32, 32 ** 3, 32, 2) == 256
    assert cuda_fused.bwd_tile(32, 4 ** 3, 256, 2) == 1
