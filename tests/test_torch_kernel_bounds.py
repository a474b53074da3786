"""K1, K4 and K7 at any point count N and width C, pinned on the CPU.

K1 (ops/cuda_voxelize.py) keeps its in-tile list kernel where the list
fits a block's shared memory and takes the points in rounds beyond
(`plan`); K4 and K7 (ops/cuda_interp.py, ops/cuda_fused.py) sort a
sample's 3N contributions in one block up to N = 2048 and in chunks beyond
(`index_plan`, `index_scratch_words`), and their writers take C in slices
of 256 channels. Here: every plan at N = 4096, 8192 and 16384 and C up to
512 fits an H100 block (232,448 bytes of shared memory, 1024 threads, the
grid's limits), and the plain versions that the kernels are held to on the
card equal the JAX functions at N = 4096: K1 the XLA scatter, K4 the VJP
of the Pallas interpolation (interpret mode, as the JAX tests run it), K7
that of the XLA compaction followed by the Pallas interpolation. The
kernels themselves run on the card only (chip_smoke.py phase 17).
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dcl_net_tpu.ops.voxelize  # noqa: F401
from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu.ops.pallas_interp import pallas_nn_interpolate
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine

# dcl_net_tpu.ops re-exports a function named voxelize over its module
jvox = sys.modules["dcl_net_tpu.ops.voxelize"]

torch.set_num_threads(2)

H100_SMEM = 232448  # bytes of shared memory a block may take
STATIC_SMEM = 48 * 1024  # nvcc's bound on a kernel's static shared memory
MAX_THREADS = 1024
GRID_X, GRID_Y = 2 ** 31 - 1, 65535
N_LARGE = (4096, 8192, 16384)
D = 16
GRID = (D, D, D)
N = 4096


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("c", [7, 64, 512])
@pytest.mark.parametrize("n", (1024,) + N_LARGE)
def test_voxelize_plan_fits_an_h100(n, c):
    p = cuda_voxelize.plan(n, c)
    # the dynamic shared memory, with the kernel's static words beside it
    assert p.smem <= cuda_voxelize.SMEM_LIMIT <= H100_SMEM - 1024
    assert 1 <= p.tile <= cuda_voxelize.TILE and cuda_voxelize.THREADS <= MAX_THREADS
    assert -(-64 ** 3 // p.tile) <= GRID_X
    if p.round_len == 0:  # the list kernel: every point of a sample fits
        assert p.smem == cuda_voxelize.list_smem_bytes(n, c) and p.cw == c
    else:
        assert 1 <= p.round_len <= n and 1 <= p.cw <= min(c, cuda_voxelize.ROUND_CHANNELS)
        carried = 4 * p.tile * (p.cw + 2)
        assert carried <= cuda_voxelize.SMEM_LIMIT // 2
        assert p.smem == carried + 4 * p.round_len * (2 + p.cw)


@pytest.mark.parametrize("v", [64, 2048])
@pytest.mark.parametrize("n", (1024,) + N_LARGE)
def test_inverse_index_plan_and_scratch_fit_an_h100(n, v):
    b = 32
    plan = cuda_interp.index_plan(b, n, v)
    chunks = cuda_interp.index_chunks(n)
    if n <= cuda_interp.MAX_POINTS:
        assert chunks == 0 and [k for k, _, _ in plan] == ["build_csr"]
    else:
        assert chunks == -(-3 * n // cuda_interp.INDEX_CHUNK_ENTRIES) >= 2
        assert [k for k, _, _ in plan] == ["chunk_counts", "scan_counts", "place_chunk"]
    for _, (x, y), threads in plan:
        assert x <= GRID_X and y <= GRID_Y and threads <= MAX_THREADS
    # a chunk's sorted keys (and the sort's storage, which they share) stay
    # within the static shared memory
    assert 4 * cuda_interp.INDEX_CHUNK_ENTRIES <= STATIC_SMEM
    # start [B, V + 1], ent [B, 3N], then the chunks' counts [B, V + 1, chunks]
    assert cuda_interp.index_scratch_words(b, n, v) == b * (v + 1 + 3 * n + (v + 1) * chunks)


@pytest.mark.parametrize("c", [256, 512, 1024])
def test_writers_at_wide_channels_fit_an_h100(c):
    assert cuda_interp.writer_rows(c) == 1
    assert cuda_interp.WRITER_THREADS <= MAX_THREADS
    assert cuda_interp.WRITER_SMEM + 8 <= STATIC_SMEM  # K7 adds its slot range
    for b, cells in ((32, 64 ** 3), (4, D ** 3), (32, 4 ** 3)):
        tile = cuda_fused.bwd_tile(b, cells, c)
        assert tile >= 1 and b * -(-cells // tile) <= GRID_X * 1 and b <= GRID_Y
    # K5's and K7's tile of 16 KB of bf16 or f32 rows holds one row at least
    assert cuda_compact.bwd_tile(c, 4) >= 1 and cuda_compact.bwd_tile(c, 2) >= 1


@pytest.mark.parametrize("mode", [3, 4])
def test_voxelize_plain_at_4096_points_equals_jax(mode):
    rng = np.random.RandomState(40 + mode)
    b, c = 2, 7
    vidx = rng.randint(0, D, size=(b, N, 3)).astype(np.int32)
    vidx[:, : N // 4] = (3, 5, 7)  # a cell of a thousand points
    feats = rng.randn(b, N, c).astype(np.float32)
    mask = (rng.rand(b, N) > 0.2).astype(np.float32)
    grid, count = cuda_voxelize.voxelize_cuda(_t(feats), _t(vidx), GRID, mode, _t(mask))
    xg, xc = jvox.voxelize_dense(jnp.asarray(feats), jnp.asarray(vidx), GRID, mode=mode,
                                 point_mask=jnp.asarray(mask > 0))
    np.testing.assert_array_equal(count.numpy(), np.asarray(xc))
    assert float(count.max()) >= 700
    # both sum each cell in point order; XLA's CPU scatter may round the
    # hot cell's thousand-term sum once otherwise: 2e-5 of sums of ~30
    np.testing.assert_allclose(grid.numpy(), np.asarray(xg), rtol=0, atol=2e-5)
    assert cuda_voxelize.launches == 0


def _interp_inputs(rng, v=256, c=8):
    b = 2
    pts = ((rng.rand(b, N, 3) - 0.5) * 0.3).astype(np.float32)
    ctr = ((rng.rand(b, v, 3) - 0.5) * 0.3).astype(np.float32)
    feats = rng.randn(b, v, c).astype(np.float32)
    mask = (rng.rand(b, v) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[1, [0, 9]] = 1.0  # two valid centers: 2N contributions on two rows
    g = rng.randn(b, N, c).astype(np.float32)
    return pts, ctr, feats * mask[..., None], mask, g


def test_interp_backward_plain_at_4096_points_equals_pallas_vjp():
    pts, ctr, feats, mask, g = _interp_inputs(np.random.RandomState(44))
    _, w, idx = cuda_interp.nn_interpolate_cuda(_t(pts), _t(ctr), _t(feats), _t(mask))
    got = cuda_interp.nn_interpolate_bwd_cuda(_t(g), w, idx, feats.shape[1]).numpy()
    _, vjp = jax.vjp(lambda f: pallas_nn_interpolate(
        jnp.asarray(pts), jnp.asarray(ctr), f, jnp.asarray(mask)), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    # the same neighbours and weights; a row of sample 1 sums about 4096
    # terms w * g in entry order, the one-hot matmul in another: 1e-5 of
    # the row (1.9e-6 seen)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # the inverse index of those 3N = 12288 entries, as the card's chunked
    # sort must give it: stable by slot
    start, ent = cuda_interp.inverse_index_cuda(idx, feats.shape[1])
    keys = idx.reshape(2, -1).long().gather(1, ent.long())
    assert bool((keys[:, 1:] >= keys[:, :-1]).all())
    same = keys[:, 1:] == keys[:, :-1]
    assert bool((ent[:, 1:] > ent[:, :-1])[same].all())
    assert start[:, -1].tolist() == [3 * N, 3 * N] and cuda_interp.bwd_launches == 0


def test_fused_backward_plain_at_4096_points_equals_jax_vjp():
    """K7's plain version (the fused op's backward on CPU tensors) against
    the grid gradient of the XLA compaction (the port's slot order) followed
    by the Pallas interpolation."""
    rng = np.random.RandomState(45)
    b, c, cap = 2, 6, 512
    feats = np.zeros((b, D, D, D, c), np.float32)
    mask = np.zeros((b, D, D, D), np.float32)
    for bi, occ in enumerate((300, 2)):  # a spread sample, and one of two voxels
        cells = np.unravel_index(rng.choice(D ** 3, occ, replace=False), GRID)
        mask[(bi,) + cells] = 1.0
        feats[(bi,) + cells] = rng.randn(occ, c)
    unit, scale = (0.024,) * 3, 1.0
    offset = tuple(-0.5 * 0.024 * D for _ in range(3))
    pts = ((rng.rand(b, N, 3) - 0.5) * 0.38).astype(np.float32)
    g = rng.randn(b, N, c).astype(np.float32)

    def jf(grid):
        coords, vf, vm = jsc.dense_to_sparse(grid, jnp.asarray(mask), cap)
        return pallas_nn_interpolate(jnp.asarray(pts),
                                     jsc.voxel_centers(coords, unit, scale, offset), vf, vm)

    want_out, vjp = jax.vjp(jf, jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    grid = _t(feats).requires_grad_(True)
    unit_s, off_c = voxel_center_affine(unit, scale, offset)
    out, _ = cuda_fused.compact_interpolate(grid, _t(mask), _t(pts), cap, unit_s, off_c)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    # the two-voxel sample's cells take all its 3N terms, in other orders:
    # 1e-5 of the cell (1.9e-6 seen)
    np.testing.assert_allclose(grid.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert cuda_fused.bwd_launches == 0
