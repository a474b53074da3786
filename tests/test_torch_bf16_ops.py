"""The plain versions of the bf16 kernels (K1, K2, K3, K6 with
model.compute_dtype: bfloat16) against the JAX package's Pallas functions
in bf16, run as the JAX tests run them on the CPU (interpret mode), and the
dtype guards: the backward kernels take a bf16 cotangent and refuse a
float16 one, a bf16 model trains with f32 parameters, and a refiner trains
in f32 only.

The JAX bf16 kernels cast their blocks to f32 and their outputs to bf16;
the port's plain versions take the same rounding points, so the outputs
agree to within one bf16 ulp (a sum taken in another order can round the
other way) and the selections (idx, coords, counts) exactly.
"""

import sys

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
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.models.refiner import Refiner
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize
import dcl_net_tpu_torch.ops.knn  # noqa: F401
from dcl_net_tpu_torch.ops import sparse_conv as tsc
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine
from dcl_net_tpu_torch.train.solver import TrainState, build_optimizer, make_train_step
from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step
from tests.test_torch_train_ops import _occupied_grid

torch.set_num_threads(2)

# the port's ops re-exports a function named knn over its module
tknn = sys.modules["dcl_net_tpu_torch.ops.knn"]

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


def test_backward_kernels_take_bf16_cotangents_and_refuse_float16():
    """K4, K5 and K7 take a bf16 cotangent (their plain versions here, their
    bf16 variants on the card) and give a bf16 gradient; a float16 one is
    refused on every device, and never runs converted."""
    rng = np.random.RandomState(0)
    b, n, v, c = 2, 16, 8, 4
    g = torch.randn((b, n, c)).to(BF16)
    w = torch.full((b, 3, n), 1 / 3)
    idx = torch.from_numpy(rng.randint(0, v, (b, 3, n)).astype(np.int32))
    coords = torch.zeros((b, v, 3), dtype=torch.int32)
    coords[:, :, 2] = torch.arange(v)
    vmask = torch.ones((b, v))
    dv = torch.randn((b, v, c)).to(BF16)
    calls = (lambda t: cuda_interp.nn_interpolate_bwd_cuda(t, w, idx, v),
             lambda t: cuda_compact.dense_to_sparse_bwd_cuda(t[:, :v], coords, vmask,
                                                             (1, 1, v)),
             lambda t: cuda_fused.compact_interpolate_bwd_cuda(t, w, idx, coords, vmask,
                                                               (1, 1, v)))
    for call, cot in zip(calls, (g, dv, g)):
        assert call(cot).dtype == BF16
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="float16 cotangent"):
                call(cot.to(device=dev, dtype=torch.float16))
    # a gradient through the bf16 forward comes back bf16
    feats = torch.randn((b, v, c)).to(BF16).requires_grad_()
    out = cuda_interp.nn_interpolate(torch.randn(b, n, 3), torch.randn(b, v, 3), feats,
                                     torch.ones(b, v))
    out.float().sum().backward()
    assert feats.grad.dtype == BF16 and bool(torch.isfinite(feats.grad.float()).all())
    assert (cuda_interp.bwd_launches_bf16 == cuda_compact.bwd_launches_bf16
            == cuda_fused.bwd_launches_bf16 == 0)


def test_bf16_model_trains_with_f32_parameters():
    """A bf16 model takes train mode and a step of make_train_step, whose
    gradients, optimizer state and BN statistics stay f32; a bf16 stage 1
    goes into make_stage2_train_step, but a refiner in bf16 does not, and a
    float16 model cannot be built."""
    kw = dict(unit_voxel_extent=(0.024,) * 3, voxel_num_limit=(D,) * 3)
    model = DCLNet(capacities=(256, 64, 16, 8), device="cpu", dtype=BF16, **kw)
    assert model.train() is model and model.training
    ds = SyntheticPoseDataset(n_objects=2, n_points=128, seed=0, **kw)
    batch = batch_to_torch(make_batch([ds[0], ds[1]]).to_dict(), "cpu")
    opt, _ = build_optimizer(Config({"optimizer": {"type": "Adam", "lr": 1e-3}}), 1)
    step = make_train_step(model, opt, dcl_losses)
    state = TrainState(opt.init(sum(p.numel() for p in model.parameters())))
    before = [p.detach().clone() for p in model.parameters()]
    stats_before = [t.clone() for n, t in model.named_buffers() if "running" in n]
    metrics = step(state, batch)
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert np.isfinite(float(metrics["loss_all"])) and float(metrics["grad_norm"]) > 0
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
    stats = [t for n, t in model.named_buffers() if "running" in n]
    assert all(not torch.equal(a, t) for a, t in zip(stats_before, stats))
    # bf16 is the compute type only: parameters, statistics, Adam state f32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {t.dtype for t in stats} == {torch.float32}
    assert {v.dtype for v in state.opt_state.values() if v.is_floating_point()} == {
        torch.float32}
    refiner = Refiner(n_inp=128, device="cpu")
    make_stage2_train_step(model, refiner, opt, 2, torch.zeros(2, 32, 3))
    with pytest.raises(NotImplementedError, match="refiner trains in f32"):
        make_stage2_train_step(model, refiner.to(BF16), opt, 2, torch.zeros(2, 32, 3))
    with pytest.raises(ValueError, match="bfloat16"):
        DCLNet(device="cpu", dtype=torch.float16)
