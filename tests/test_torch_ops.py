"""The port's ops against the JAX package's, on the same numpy inputs.

Each hand-written kernel's plain version (what a CPU tensor runs) is held
to the Pallas kernel it replaces, run in interpret mode as the JAX tests
run it, and to the JAX package's XLA function; the kernels' edge cases
(out-of-grid points, capacity overflow, fewer than 3 valid centers) are
pinned here so a redesigned kernel keeps them. Small shapes: 16^3 grids,
N = 128 (the Pallas interpolation needs N % 128 == 0), B = 2 or 3.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dcl_net_tpu.ops.knn  # noqa: F401
import dcl_net_tpu.ops.voxelize  # noqa: F401
import dcl_net_tpu_torch.ops.knn  # noqa: F401
import dcl_net_tpu_torch.ops.voxelize  # noqa: F401
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu.ops.pallas_compact import pallas_dense_to_sparse
from dcl_net_tpu.ops.pallas_interp import _run_fwd as pallas_interp_fwd
from dcl_net_tpu.ops.pallas_voxelize import pallas_voxelize
from dcl_net_tpu_torch.ops import cuda_compact, cuda_interp, cuda_voxelize
from dcl_net_tpu_torch.ops import sparse_conv as tsc

# both packages' ops re-export functions named knn and voxelize over their modules
jknn = sys.modules["dcl_net_tpu.ops.knn"]
jvox = sys.modules["dcl_net_tpu.ops.voxelize"]
tknn = sys.modules["dcl_net_tpu_torch.ops.knn"]
tvox = sys.modules["dcl_net_tpu_torch.ops.voxelize"]

torch.set_num_threads(2)

GRID = (16, 16, 16)
N = 128


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x)


def _points_and_feats(rng, b=2, n=N, c=7):
    vidx = rng.randint(0, 16, size=(b, n, 3)).astype(np.int32)
    vidx[:, : n // 4] = vidx[:, :1]  # a crowded voxel: many points per cell
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = (rng.rand(b, n) > 0.2).astype(np.float32)
    return feats, vidx, mask


# ---------------------------------------------------------------- K1 voxelize
@pytest.mark.parametrize("mode", [tvox.MODE_SUM, tvox.MODE_MEAN])
def test_voxelize_plain_matches_pallas_and_xla(mode):
    rng = np.random.RandomState(mode)
    feats, vidx, mask = _points_and_feats(rng)
    grid, count = cuda_voxelize.voxelize_cuda(
        _t(feats), _t(vidx), GRID, mode, point_mask=_t(mask))
    xg, xc = jvox.voxelize_dense(jnp.asarray(feats), jnp.asarray(vidx), GRID,
                                 mode=mode, point_mask=jnp.asarray(mask > 0))
    pg, pc = pallas_voxelize(jnp.asarray(feats), jnp.asarray(vidx), GRID,
                             mode=mode, point_mask=jnp.asarray(mask))
    # counts are exact integers in f32 on every path
    np.testing.assert_array_equal(count.numpy(), _np(xc))
    np.testing.assert_array_equal(count.numpy(), _np(pc))
    # the plain version sums each voxel in point order, like the XLA
    # scatter; the Pallas one-hot matmul adds in another order: 1e-6
    np.testing.assert_allclose(grid.numpy(), _np(xg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(grid.numpy(), _np(pg), rtol=0, atol=1e-6)
    assert cuda_voxelize.launches == 0  # CPU tensors never reach the kernel


def test_voxelize_drops_out_of_grid_points():
    rng = np.random.RandomState(7)
    feats, vidx, _ = _points_and_feats(rng)
    outside = [(16, 3, 3), (3, 3, 16), (-5, 20, 2), (3, 3, -1), (3, -1, 3)]
    for k, ijk in enumerate(outside):
        vidx[0, 10 + k] = ijk
    keep = np.ones(feats.shape[:2], np.float32)
    keep[0, 10:10 + len(outside)] = 0.0
    grid, count = cuda_voxelize.voxelize_cuda(_t(feats), _t(vidx), GRID, 4)
    # dropping them equals masking them out (bit-equal: the same sums)
    mg, mc = cuda_voxelize.voxelize_cuda(_t(feats), _t(vidx), GRID, 4,
                                         point_mask=_t(keep))
    assert torch.equal(count, mc) and torch.equal(grid, mg)
    assert float(count.sum()) == feats.shape[0] * feats.shape[1] - len(outside)
    # the Pallas one-hots match neither a row z*D1 + y outside [0, D0*D1)
    # nor an x outside [0, D2): those points it drops too. (3, -1, 3) it
    # does not drop: z*D1 + y = 47 aliases the voxel (2, 15, 3), an artefact
    # of its row factorisation that the port does not copy.
    keep_pallas = np.ones_like(keep)
    keep_pallas[0, 14] = 0.0
    pg, pc = pallas_voxelize(jnp.asarray(feats), jnp.asarray(vidx), GRID, mode=4,
                             point_mask=jnp.asarray(keep_pallas))
    np.testing.assert_array_equal(count.numpy(), _np(pc))
    np.testing.assert_allclose(grid.numpy(), _np(pg), rtol=0, atol=1e-6)


def test_point_to_voxel_index_matches_jax():
    rng = np.random.RandomState(3)
    pts = ((rng.rand(2, 64, 3) - 0.5) * 0.5).astype(np.float32)  # some outside
    unit = (0.024,) * 3
    got = tvox.point_to_voxel_index(_t(pts), unit, GRID)
    want = jvox.point_to_voxel_index(jnp.asarray(pts), unit, GRID)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------- K2 compaction
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
def test_compaction_plain_matches_xla_and_pallas(cap):
    rng = np.random.RandomState(cap)
    feats, mask = _occupied_grid(rng, occupancy=(40, 100))  # 100 > 64 overflows
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(
        _t(feats), _t(mask), cap)
    xc, xf, xm = jsc.dense_to_sparse(jnp.asarray(feats), jnp.asarray(mask), cap)
    # bit-equal to the XLA top_k extraction, padding rows included
    np.testing.assert_array_equal(coords.numpy(), _np(xc))
    np.testing.assert_array_equal(vfeats.numpy(), _np(xf))
    np.testing.assert_array_equal(vmask.numpy(), _np(xm))
    # the overflow flag is the XLA path's occupancy > capacity
    want_occ = (mask.reshape(2, -1) > 0).sum(1)
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    np.testing.assert_array_equal((occ > cap).numpy(), want_occ > cap)
    assert bool((occ > cap).any()) == (cap == 64)
    # the Pallas output has alignment gaps: its valid rows are the first k
    # occupied cells in linear order, equal to the plain version's first k
    pc, pf, pm = pallas_dense_to_sparse(jnp.asarray(feats), jnp.asarray(mask), cap)
    for bi in range(2):
        valid = _np(pm[bi]) > 0
        k = int(valid.sum())
        assert k == min(cap, want_occ[bi]) or cap == 64
        np.testing.assert_array_equal(_np(pc[bi])[valid], coords[bi, :k].numpy())
        np.testing.assert_array_equal(_np(pf[bi])[valid], vfeats[bi, :k].numpy())
    assert cuda_compact.launches == 0


def test_sparse_conv_ops_match_jax():
    rng = np.random.RandomState(5)
    feats, mask = _occupied_grid(rng, occupancy=(60, 30), d=8, c=5)
    tf, tm = _t(feats), _t(mask)
    np.testing.assert_array_equal(
        tsc.dilate_mask(tm, 3).numpy(), _np(jsc.dilate_mask(jnp.asarray(mask), 3)))
    pf, pm = tsc.sparse_avg_pool(tf, tm, 3, 2)
    jf, jm = jsc.sparse_avg_pool(jnp.asarray(feats), jnp.asarray(mask), 3, 2)
    np.testing.assert_array_equal(pm.numpy(), _np(jm))
    # window sums over up to 27 terms in another order: 1e-6
    np.testing.assert_allclose(pf.numpy(), _np(jf), rtol=0, atol=1e-6)
    mean, var = tsc.masked_batch_norm_stats(tf, tm)
    jmean, jvar = jsc.masked_batch_norm_stats(jnp.asarray(feats), jnp.asarray(mask))
    np.testing.assert_allclose(mean.numpy(), _np(jmean), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(var.numpy(), _np(jvar), rtol=1e-5, atol=1e-7)
    coords = rng.randint(0, 8, size=(2, 10, 3)).astype(np.int32)
    unit, offset = (0.006,) * 3, (-0.192,) * 3
    np.testing.assert_allclose(
        tsc.voxel_centers(_t(coords), unit, 6, offset).numpy(),
        _np(jsc.voxel_centers(jnp.asarray(coords), unit, 6, offset)),
        rtol=0, atol=1e-7)


@pytest.mark.parametrize("d, c", [(8, 5), (2, 3)])
def test_window_sum_in_one_padded_buffer_equals_pad_then_pool(d, c):
    """window_sum writes x * mask into one zero-padded buffer: the same
    values as multiplying, padding with F.pad and pooling, and the same
    gradient, on a grid of the kernel's size (the 2^3 level of 16^3) too."""
    rng = np.random.RandomState(d)
    x = torch.tensor(rng.randn(2, d, d, d, c).astype(np.float32), requires_grad=True)
    m = torch.tensor((rng.rand(2, d, d, d) > 0.4).astype(np.float32))

    def pad_then_pool(x):
        xp = torch.nn.functional.pad((x * m[..., None]).permute(0, 4, 1, 2, 3), (1,) * 6)
        return torch.nn.functional.avg_pool3d(xp, 3, 2, divisor_override=1).permute(0, 2, 3, 4, 1)

    got, want = tsc.window_sum(x, 3, 2, 1, mask=m), pad_then_pool(x)
    assert torch.equal(got, want)
    g = torch.tensor(rng.randn(*want.shape).astype(np.float32))
    (gx,) = torch.autograd.grad(got, x, g)
    (wx,) = torch.autograd.grad(want, x, g)
    assert torch.equal(gx, wx)
    with torch.inference_mode():
        assert torch.equal(tsc.window_sum(x.detach(), 3, 2, 1, mask=m), want.detach())

# ---------------------------------------------------------------- K3 interpolation
def _interp_inputs(rng, v=256, c=8):
    b = 3
    pts = ((rng.rand(b, N, 3) - 0.5) * 0.3).astype(np.float32)
    ctr = ((rng.rand(b, v, 3) - 0.5) * 0.3).astype(np.float32)
    feats = rng.randn(b, v, c).astype(np.float32)
    mask = (rng.rand(b, v) > 0.3).astype(np.float32)
    # fewer than 3 valid centers: sample 1 has two (one of them index 0),
    # sample 2 has one
    mask[1] = 0.0
    mask[1, [0, 77]] = 1.0
    mask[2] = 0.0
    mask[2, 130] = 1.0
    feats = feats * mask[..., None]  # padding rows are zero, as compacted
    return pts, ctr, feats, mask


def test_interp_plain_matches_pallas():
    pts, ctr, feats, mask = _interp_inputs(np.random.RandomState(11))
    out, w, idx = cuda_interp.nn_interpolate_cuda(_t(pts), _t(ctr), _t(feats), _t(mask))
    pout, pw, pidx = pallas_interp_fwd(jnp.asarray(pts), jnp.asarray(ctr),
                                       jnp.asarray(feats), jnp.asarray(mask))
    # same distances (direct differences), same iterated argmin: the same
    # neighbours, including the repeated index 0 of the 1-2 valid samples
    np.testing.assert_array_equal(idx.numpy(), _np(pidx))
    np.testing.assert_allclose(w.numpy(), _np(pw), rtol=1e-6, atol=1e-7)
    # weighted sums in another order: 1e-6
    np.testing.assert_allclose(out.numpy(), _np(pout), rtol=0, atol=1e-6)
    assert cuda_interp.launches == 0


def test_interp_plain_matches_xla_expansion_path():
    pts, ctr, feats, mask = _interp_inputs(np.random.RandomState(12))
    out, _, idx = cuda_interp.nn_interpolate_cuda(_t(pts), _t(ctr), _t(feats), _t(mask))
    want = jknn.nearest_neighbor_interpolate(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(feats), jnp.asarray(mask))
    # the XLA path's |a|^2 - 2ab + |b|^2 distances round differently: 1e-5
    np.testing.assert_allclose(out.numpy(), _np(want), rtol=0, atol=1e-5)
    # the port's own expansion-form function follows the XLA path
    tout = tknn.nearest_neighbor_interpolate(_t(pts), _t(ctr), _t(feats), _t(mask))
    np.testing.assert_allclose(tout.numpy(), _np(want), rtol=0, atol=1e-6)
    _, jidx = jknn.three_nn(jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(mask))
    np.testing.assert_array_equal(idx[0].T.numpy(), _np(jidx)[0])


@pytest.mark.parametrize("k", [3, 6])
def test_knn_matches_jax(k):
    rng = np.random.RandomState(k)
    q = (rng.rand(2, 16, 3) - 0.5).astype(np.float32)
    ref = (rng.rand(2, 4, 3) - 0.5).astype(np.float32)  # k = 6 > 4 refs: repeats
    mask = np.ones((2, 4), np.float32)
    mask[1, 2] = 0.0
    d2, idx = tknn.knn(k, _t(q), _t(ref), _t(mask))
    jd2, jidx = jknn.knn(k, jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_allclose(d2.numpy(), _np(jd2), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- no silent fallback
def test_kernel_wrappers_refuse_non_cpu_tensors_without_the_kernel():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel or raises, it never runs the plain version quietly."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_voxelize.voxelize_cuda(torch.empty(2, N, 7, **meta),
                                    torch.empty(2, N, 3, dtype=torch.int32, **meta),
                                    GRID, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_compact.dense_to_sparse_cuda(torch.empty(2, 8, 8, 8, 4, **meta),
                                          torch.empty(2, 8, 8, 8, **meta), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_interp.nn_interpolate_cuda(torch.empty(2, N, 3, **meta),
                                        torch.empty(2, 16, 3, **meta),
                                        torch.empty(2, 16, 4, **meta),
                                        torch.empty(2, 16, **meta))
    assert cuda_voxelize.launches == cuda_compact.launches == cuda_interp.launches == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from dcl_net_tpu_torch.ops import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if cuda_build.os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc; the build would succeed")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    cuda_build.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.library()
    cuda_build.library.cache_clear()
    assert not (tmp_path / "build").exists()
