"""What the two grid-writing kernels, K1 (voxelize) and K5 (the compaction's
backward), rely on, pinned on the CPU.

K5 finds each tile's slots by a search of the compaction's valid prefix, so
it needs the compaction's output to have its valid slots first, in strictly
rising linear-index order, with zero padding: the plain dense_to_sparse
(and the JAX package's, which it matches bit for bit) is held to that here.
K1 sums each cell's points in point order and divides by max(count, 1), to
be bit-equal to its plain version: the plain voxelize_dense is held, bit
for bit, to a numpy float32 loop that does exactly that. K1 keeps its
tile's points in shared memory, which bounds N: the wrapper's check is
called directly. Small shapes: 16^3 grids.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu_torch.ops import cuda_compact, cuda_voxelize
from dcl_net_tpu_torch.ops.voxelize import MODE_MEAN, MODE_SUM, voxelize_dense

torch.set_num_threads(2)

D = 16
G = D ** 3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid(fill: str, b: int = 3, c: int = 5, seed: int = 0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, D, D, D, c).astype(np.float32)
    if fill == "empty":
        mask = np.zeros((b, D, D, D), np.float32)
    elif fill == "full":
        mask = np.ones((b, D, D, D), np.float32)
    else:  # ~5 % occupied, one sample empty
        mask = (rng.rand(b, D, D, D) < 0.05).astype(np.float32)
        mask[1] = 0.0
    return feats, mask


def _assert_slot_prefix(coords, vfeats, vmask, occupancy, cap):
    """K5's precondition: valid slots are [0, min(occupancy, cap)), their
    linear indices rise strictly, and padding rows are zero."""
    n_valid = np.minimum(occupancy, cap)
    slots = np.arange(cap)
    np.testing.assert_array_equal(vmask > 0, slots[None] < n_valid[:, None])
    lin = (coords[..., 0].astype(np.int64) * D + coords[..., 1]) * D + coords[..., 2]
    for b, k in enumerate(n_valid):
        assert np.all(np.diff(lin[b, :k]) > 0)
        assert np.all(coords[b, k:] == 0) and np.all(vfeats[b, k:] == 0)
    assert np.all((vmask == 0) | (vmask == 1))


@pytest.mark.parametrize("fill", ["sparse", "empty", "full"])
@pytest.mark.parametrize("cap", [1, 50, 700, G])
def test_compaction_meets_the_backward_precondition(fill, cap):
    feats, mask = _grid(fill, seed=cap)
    occupancy = (mask.reshape(mask.shape[0], -1) > 0).sum(1)
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(_t(feats), _t(mask), cap)
    np.testing.assert_array_equal(occ.numpy(), occupancy)
    _assert_slot_prefix(coords.numpy(), vfeats.numpy(), vmask.numpy(), occupancy, cap)
    # the JAX package's compaction, which the port's matches, meets it too
    jc, jf, jm = jsc.dense_to_sparse(jnp.asarray(feats), jnp.asarray(mask), cap)
    _assert_slot_prefix(np.asarray(jc), np.asarray(jf), np.asarray(jm), occupancy, cap)
    # and the plain K5 on it writes each valid row into its cell, zeros elsewhere
    rng = np.random.RandomState(cap + 1)
    dv = rng.randn(*vfeats.shape).astype(np.float32)
    got = cuda_compact.dense_to_sparse_bwd_cuda(_t(dv), coords, vmask, (D, D, D)).numpy()
    want = np.zeros(feats.shape, np.float32).reshape(feats.shape[0], G, -1)
    for b, k in enumerate(np.minimum(occupancy, cap)):
        lin = (coords[b, :k, 0].long() * D + coords[b, :k, 1]) * D + coords[b, :k, 2]
        want[b, lin.numpy()] = dv[b, :k]
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert cuda_compact.launches == cuda_compact.bwd_launches == 0


def _serial_voxelize(feats, vidx, mode, mask):
    """Each cell's points added in point order from 0 in float32, then the
    sum divided by max(count, 1) in float32 (mode 4)."""
    b, n, c = feats.shape
    acc = np.zeros((b, G, c), np.float32)
    cnt = np.zeros((b, G), np.float32)
    for bi in range(b):
        for p in range(n):
            i = vidx[bi, p]
            if (mask is not None and not mask[bi, p] > 0) or np.any(i < 0) or np.any(i >= D):
                continue
            cell = (int(i[0]) * D + int(i[1])) * D + int(i[2])
            for k in range(c):
                acc[bi, cell, k] = np.float32(acc[bi, cell, k] + feats[bi, p, k])
            cnt[bi, cell] += np.float32(1.0)
    if mode == MODE_MEAN:
        acc = acc / np.maximum(cnt, np.float32(1.0))[..., None]
    return acc.reshape(b, D, D, D, c), cnt.reshape(b, D, D, D)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mode", [MODE_SUM, MODE_MEAN])
def test_voxelize_plain_is_the_point_order_serial_sum(mode, masked):
    rng = np.random.RandomState(10 * mode + masked)
    b, n, c = 3, 256, 7
    vidx = rng.randint(0, D, size=(b, n, 3))
    vidx[:, : n // 2] = rng.randint(5, 7, size=(b, n // 2, 3))  # 8 cells, ~16 points each
    vidx[0, -40:] = vidx[0, 0]                                  # one cell with 40 + points
    vidx[1, 200:210, 0] = -1                                    # out of range on each axis
    vidx[1, 210:220, 1] = D
    vidx[1, 220:230, 2] = 1000
    vidx = vidx.astype(np.int32)
    # features of mixed magnitude, so that the order of the sums shows
    feats = (rng.randn(b, n, c) * 10.0 ** rng.randint(-3, 4, size=(b, n, 1))).astype(np.float32)
    mask = (rng.rand(b, n) > 0.2).astype(np.float32) if masked else None
    if masked:
        mask[2] = 0.0  # a sample with every point masked
    grid, count = voxelize_dense(_t(feats), _t(vidx), (D, D, D), mode,
                                 None if mask is None else _t(mask))
    wg, wc = _serial_voxelize(feats, vidx, mode, mask)
    np.testing.assert_array_equal(count.numpy(), wc)
    # bit for bit, signs of zero included
    np.testing.assert_array_equal(grid.numpy().view(np.int32), wg.view(np.int32))
    assert count.numpy().max() >= 40


def test_voxelize_shared_memory_limit_raises_for_too_many_points():
    """Past the list kernel's limit the planner no longer raises: it takes
    the rounds kernel, the main path's N keeps the list kernel."""
    c = 7
    fits = (cuda_voxelize.SMEM_LIMIT - 4 * cuda_voxelize.TILE) // (4 * (2 + c))
    main = cuda_voxelize.plan(1024, c)
    assert main == cuda_voxelize.Plan(cuda_voxelize.TILE, 4 * (1024 * 9 + cuda_voxelize.TILE),
                                      c, 0)
    assert cuda_voxelize.plan(fits, c).round_len == 0
    beyond = cuda_voxelize.plan(fits + 1, c)
    assert beyond.round_len > 0 and beyond.tile == cuda_voxelize.TILE
    # a wider C halves the tile until the carried sums take half the memory
    wide = cuda_voxelize.plan(fits, 512)
    assert wide.round_len > 0 and wide.cw == cuda_voxelize.ROUND_CHANNELS
    assert wide.tile < cuda_voxelize.TILE


@pytest.mark.parametrize("c,cells", [(32, 128), (64, 64), (128, 32), (256, 16), (7, 585)])
def test_compaction_backward_tiles_are_16_kb(c, cells):
    assert cuda_compact.bwd_tile(c) == cells
    assert cells * c * 4 <= cuda_compact.BWD_TILE_BYTES

