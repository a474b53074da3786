"""The plain versions of the bf16 kernels (K1, K2, K3, K6 with
model.compute_dtype: bfloat16) against the JAX package's Pallas functions
in bf16, run as the JAX tests run them on the CPU (interpret mode), and the
guards that keep bf16 out of the backward kernels and out of training.

The JAX bf16 kernels cast their blocks to f32 and their outputs to bf16;
the port's plain versions take the same rounding points, so the outputs
agree to within one bf16 ulp (a sum taken in another order can round the
other way) and the selections (idx, coords, counts) exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.ops import pallas_fused, pallas_interp
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu.ops.pallas_compact import (
    capacity_overflow, compact_raw, pallas_dense_to_sparse,
)
from dcl_net_tpu.ops.pallas_voxelize import pallas_voxelize
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.models.refiner import Refiner
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize
from dcl_net_tpu_torch.ops import knn as tknn
from dcl_net_tpu_torch.ops import sparse_conv as tsc
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine
from dcl_net_tpu_torch.train.solver import make_train_step, refuse_bf16_training
from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step
from tests.test_torch_train_ops import _occupied_grid

torch.set_num_threads(2)

D = 16
BF16 = torch.bfloat16


def bf16_bits(x) -> np.ndarray:
    """The int16 bit patterns of a bf16 torch tensor or JAX array."""
    if torch.is_tensor(x):
        assert x.dtype == BF16
        return x.contiguous().view(torch.int16).numpy()
    x = np.asarray(x)
    assert x.dtype == jnp.bfloat16
    return x.view(np.int16)


def ulps(a, b) -> np.ndarray:
    """Distance in bf16 ulps between two bf16 arrays, elementwise (+0 and
    -0 are one value)."""
    def ordered(bits):
        i = bits.astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(ordered(bf16_bits(a)) - ordered(bf16_bits(b)))


def _t(x):
    return torch.from_numpy(np.array(x))


def clustered_points(rng, b, n, c):
    """[B, N, C] f32 features, int32 voxel indices inside a 16^3 grid packed
    into a 4^3 corner (many points a voxel), and an f32 point mask."""
    feats = (rng.randn(b, n, c) * 3).astype(np.float32)
    vidx = rng.randint(0, 4, (b, n, 3)).astype(np.int32) + np.array([3, 9, 5], np.int32)
    mask = (rng.rand(b, n) > 0.2).astype(np.float32)
    return feats, vidx, mask


@pytest.mark.parametrize("mode", [3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_k1_bf16_matches_pallas_voxelize(mode, masked):
    rng = np.random.RandomState(10 * mode + masked)
    feats, vidx, mask = clustered_points(rng, 2, 300, 7)
    pm = mask if masked else None
    want, want_count = pallas_voxelize(
        jnp.asarray(feats), jnp.asarray(vidx), (D,) * 3, mode,
        None if pm is None else jnp.asarray(pm), out_dtype=jnp.bfloat16)
    got, count = cuda_voxelize.voxelize_cuda(
        _t(feats), _t(vidx), (D,) * 3, mode, None if pm is None else _t(pm),
        out_dtype=BF16)
    assert got.dtype == BF16 and count.dtype == torch.float32
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    assert count.max() > 3  # cells of several points: the sum's rounding shows
    assert ulps(got, want).max() <= 1
    # the f32 grid is untouched by the option
    f32, _ = cuda_voxelize.voxelize_cuda(_t(feats), _t(vidx), (D,) * 3, mode,
                                         None if pm is None else _t(pm))
    assert f32.dtype == torch.float32


def test_plain_k1_bf16_rounds_the_sum_then_the_mean():
    """Mode 4 divides the bf16 sum, not the f32 one: one voxel whose f32
    sum and bf16 sum give means that round apart."""
    feats = np.array([[[1.0 + 2 ** -7] * 7, [1.0 + 2 ** -8] * 7, [1.0] * 7]], np.float32)
    vidx = np.zeros((1, 3, 3), np.int32)
    got, _ = cuda_voxelize.voxelize_cuda(_t(feats), _t(vidx), (2, 2, 2), 4, out_dtype=BF16)
    # bf16(1 + 2^-8) = 1 (ties to even); the bf16 sum of 1 + 2^-7, 1, 1 is
    # 3 + 2^-7 -> bf16 3.0; 3 / 3 = 1. The f32 route would give 1 + 2^-7.
    assert float(got[0, 0, 0, 0, 0]) == 1.0
    want, _ = pallas_voxelize(jnp.asarray(feats), jnp.asarray(vidx), (2, 2, 2), 4,
                              out_dtype=jnp.bfloat16)
    assert float(np.asarray(want)[0, 0, 0, 0, 0].astype(np.float32)) == 1.0


@pytest.mark.parametrize("occupancy", [(40, 130), (0, 250)])
def test_plain_k2_bf16_matches_pallas_compaction(occupancy):
    rng = np.random.RandomState(sum(occupancy))
    c, cap = 32, 512
    feats, mask = _occupied_grid(rng, occupancy=occupancy, d=D, c=c)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    assert not bool(capacity_overflow(jnp.asarray(mask), cap).any())
    jc, jf, jm = pallas_dense_to_sparse(fb, jnp.asarray(mask), cap)
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(
        _t(np.asarray(fb.astype(jnp.float32))).to(BF16), _t(mask), cap)
    assert vfeats.dtype == BF16 and vmask.dtype == torch.float32
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occupancy, np.int32))
    # the Pallas layout leaves 8-aligned gaps between chunks; its valid rows,
    # in order, are the port's valid prefix
    jvalid, valid = np.asarray(jm) > 0, vmask.numpy() > 0
    np.testing.assert_array_equal(jvalid.sum(1), occ.numpy())
    for b in range(len(occupancy)):
        assert valid[b, :occupancy[b]].all() and not valid[b, occupancy[b]:].any()
        np.testing.assert_array_equal(coords.numpy()[b][valid[b]], np.asarray(jc)[b][jvalid[b]])
        np.testing.assert_array_equal(bf16_bits(vfeats)[b][valid[b]],
                                      bf16_bits(jf)[b][jvalid[b]])


def interp_inputs(rng, b=2, n=256, v=100, c=32):
    points = ((rng.rand(b, n, 3) - 0.5) * 0.4).astype(np.float32)
    centers = ((rng.rand(b, v, 3) - 0.5) * 0.4).astype(np.float32)
    feats = jnp.asarray(rng.randn(b, v, c).astype(np.float32)).astype(jnp.bfloat16)
    mask = (rng.rand(b, v) > 0.3).astype(np.float32)
    return points, centers, feats, mask


@pytest.mark.parametrize("c", [32, 12])
def test_plain_k3_bf16_matches_pallas_interp(c):
    rng = np.random.RandomState(c)
    points, centers, feats, mask = interp_inputs(rng, c=c)
    jargs = (jnp.asarray(points), jnp.asarray(centers), feats, jnp.asarray(mask))
    want = jax.jit(pallas_interp.pallas_nn_interpolate)(*jargs)
    _, jw, jidx = jax.jit(pallas_interp._run_fwd)(*jargs)
    tfeats = _t(np.asarray(feats.astype(jnp.float32))).to(BF16)
    out, w, idx = cuda_interp.nn_interpolate_cuda(_t(points), _t(centers), tfeats, _t(mask))
    assert out.dtype == BF16 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    assert ulps(out, want).max() <= 1
    # idx and w are the f32 path's: the features' type does not enter them
    _, w32, idx32 = cuda_interp.nn_interpolate_cuda(_t(points), _t(centers), tfeats.float(),
                                                    _t(mask))
    assert torch.equal(idx, idx32) and torch.equal(w, w32)


@pytest.mark.parametrize("occupancy", [(60, 150), (3, 240)])
def test_plain_k6_bf16_matches_pallas_fused(occupancy):
    rng = np.random.RandomState(sum(occupancy))
    c, cap = 8, 256
    feats, mask = _occupied_grid(rng, occupancy=occupancy, d=D, c=c)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    assert not bool(capacity_overflow(jnp.asarray(mask), cap).any())
    pts = ((rng.rand(len(occupancy), 128, 3) - 0.5) * 0.7).astype(np.float32)
    unit, scale = (0.024,) * 3, 2.0
    offset = tuple(-0.5 * 0.024 * D * scale for _ in range(3))
    us = tuple(u * scale for u in unit)
    args = (fb, jnp.asarray(mask), jnp.asarray(pts), cap, us, offset)
    want = jax.jit(pallas_fused.pallas_compact_interpolate, static_argnums=(3, 4, 5))(*args)
    _, _, j_idx = jax.jit(pallas_fused._fused_fwd, static_argnums=(3, 4, 5))(*args)
    raw = np.asarray(compact_raw(fb, jnp.asarray(mask), cap)[0])
    j_lin = np.take_along_axis(raw[:, :, c] * 128 + raw[:, :, c + 1],
                               np.asarray(j_idx).reshape(len(occupancy), -1), 1)

    tgrid = _t(np.asarray(fb.astype(jnp.float32))).to(BF16)
    unit_s, off_c = (tuple(map(float, a)) for a in voxel_center_affine(unit, scale, offset))
    out, occ = cuda_fused.compact_interpolate(tgrid, _t(mask), _t(pts), cap, unit_s, off_c)
    assert out.dtype == BF16
    assert ulps(out, want).max() <= 1
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(tgrid, _t(mask), cap)
    got, _, idx = cuda_fused.compact_interpolate_cuda(_t(pts), coords, vfeats, vmask, occ,
                                                      unit_s, off_c)
    assert torch.equal(got, out)
    cell = torch.gather(coords.long(), 1, idx.long().reshape(len(occupancy), -1, 1).expand(
        -1, -1, 3))
    lin = ((cell[..., 0] * D + cell[..., 1]) * D + cell[..., 2]).numpy()
    np.testing.assert_array_equal(lin, j_lin.astype(np.int64))
    # K6 equals K2 -> centers -> K3 in bf16
    centers = tsc.voxel_centers(coords, unit, scale, offset)
    two = cuda_interp.nn_interpolate_cuda(_t(pts), centers, vfeats, vmask, occ)[0]
    assert torch.equal(got, two)


@pytest.mark.parametrize("d", [16, 4])
def test_bf16_sparse_avg_pool_equals_jax(d):
    """The bf16 window sum rounds after each of its three separable passes,
    as XLA's bf16 depthwise convolutions do: bit-equal to the JAX pool."""
    rng = np.random.RandomState(d)
    feats, mask = _occupied_grid(rng, occupancy=(d ** 3 // 3, d ** 3 // 9), d=d, c=8)
    fb = jnp.asarray(feats * 7).astype(jnp.bfloat16)
    want, want_mask = jsc.sparse_avg_pool(fb, jnp.asarray(mask), 3, 2)
    got, got_mask = tsc.sparse_avg_pool(_t(np.asarray(fb.astype(jnp.float32))).to(BF16),
                                        _t(mask), 3, 2)
    assert got.dtype == BF16 and got_mask.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))
    # one rounding of the f32 window sum would differ somewhere
    once = (tsc.window_sum(_t(np.asarray(fb.astype(jnp.float32))), 3, 2, 1, _t(mask))
            .to(BF16))
    assert not torch.equal(once, tsc.window_sum(
        _t(np.asarray(fb.astype(jnp.float32))).to(BF16), 3, 2, 1, _t(mask).to(BF16)))


def test_bf16_exact_interp_is_the_f32_interp_rounded_once():
    rng = np.random.RandomState(3)
    points, centers, feats, mask = interp_inputs(rng, n=64)
    fb = _t(np.asarray(feats.astype(jnp.float32))).to(BF16)
    got = tknn.nearest_neighbor_interpolate(_t(points), _t(centers), fb, _t(mask))
    want = tknn.nearest_neighbor_interpolate(_t(points), _t(centers), fb.float(), _t(mask))
    assert got.dtype == BF16 and torch.equal(got, want.to(BF16))


def test_backward_kernels_refuse_bf16_cotangents():
    """K4, K5 and K7 have no bf16 variant: a bf16 cotangent is refused on
    every device, and never runs upcast."""
    rng = np.random.RandomState(0)
    b, n, v, c = 2, 16, 8, 4
    g = torch.zeros((b, n, c), dtype=BF16)
    w = torch.full((b, 3, n), 1 / 3)
    idx = torch.from_numpy(rng.randint(0, v, (b, 3, n)).astype(np.int32))
    coords = torch.zeros((b, v, 3), dtype=torch.int32)
    vmask = torch.zeros((b, v))
    with pytest.raises(ValueError, match="A 5b"):
        cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, v)
    with pytest.raises(ValueError, match="A 5b"):
        cuda_compact.dense_to_sparse_bwd_cuda(torch.zeros((b, v, c), dtype=BF16), coords,
                                              vmask, (4, 4, 4))
    with pytest.raises(ValueError, match="A 5b"):
        cuda_fused.compact_interpolate_bwd_cuda(g, w, idx, coords, vmask, (4, 4, 4))
    # a gradient through the bf16 forward reaches the same refusal
    feats = torch.randn((b, v, c)).to(BF16).requires_grad_()
    out = cuda_interp.nn_interpolate(torch.randn(b, n, 3), torch.randn(b, v, 3), feats,
                                     torch.ones(b, v))
    with pytest.raises(ValueError, match="A 5b"):
        out.float().sum().backward()


def test_bf16_model_refuses_to_train():
    model = DCLNet(unit_voxel_extent=(0.024,) * 3, voxel_num_limit=(D,) * 3,
                   capacities=(256, 64, 16, 8), device="cpu", dtype=BF16)
    assert not model.training
    refiner = Refiner(n_inp=128, device="cpu")
    for call in (model.train, lambda: refuse_bf16_training(model),
                 lambda: make_train_step(model, None, None),
                 lambda: make_stage2_train_step(model, refiner, None, 2, None)):
        with pytest.raises(NotImplementedError, match="f32 only.*A 5b"):
            call()
    # its parameters stay f32: bf16 is the compute type only
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="bfloat16"):
        DCLNet(device="cpu", dtype=torch.float16)
