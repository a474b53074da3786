"""What the 3-NN interpolation's two backward kernels, K4 (into the
compacted rows, ops/cuda_interp.py) and K7 (onto the grid,
ops/cuda_fused.py), rely on, pinned on the CPU.

Both kernels sum each slot's contributions w[k, t] * g[t, :] in ascending
e = k * N + t from 0, each product and each sum rounded once in f32, to be
bit-equal to their plain versions: the plain versions (index_add_ on CPU
tensors) are held here, bit for bit and signs of zero included, to a numpy
float32 loop that does exactly that, on inputs that stress the order (a
hot slot, cotangents of mixed magnitude, fewer than 3 valid centers, an
empty sample, capacity overflow). Both kernels group the contributions by
slot first; the plain version of that inverse index, which chip_smoke.py
holds the kernel to, is held to a numpy CSR. Then the tile and scratch
sizes of the two wrappers, and their input checks. Small shapes: 16^3
grid, N = 256.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine
from tests.test_torch_train_ops import _occupied_grid, _t

torch.set_num_threads(2)

D, C, N = 16, 8, 256
UNIT, SCALE = (0.024,) * 3, 2.0
OFFSET = tuple(-0.5 * 0.024 * D * SCALE for _ in range(3))
# occupied cells per sample: a hot sample (3 slots take all 3N
# contributions), one with fewer than 3 valid centers, an empty one, and a
# spread one that overflows the smaller capacity
OCCUPANCY = (3, 2, 0, 200)


def _inputs(cap: int, seed: int = 0):
    """The fused op's inputs at capacity cap (the plain compaction, then the
    plain K6 for w and idx), and a cotangent g of mixed magnitude."""
    rng = np.random.RandomState(seed)
    feats, mask = _occupied_grid(rng, occupancy=OCCUPANCY, d=D, c=C)
    b = len(OCCUPANCY)
    coords, vfeats, vmask = jsc.dense_to_sparse(jnp.asarray(feats), jnp.asarray(mask), cap)
    coords, vfeats, vmask = (_t(np.array(x)) for x in (coords, vfeats, vmask))
    occupancy = _t(np.asarray(OCCUPANCY, np.int32))
    pts = _t(((rng.rand(b, N, 3) - 0.5) * 0.7).astype(np.float32))
    unit_s, off_c = voxel_center_affine(UNIT, SCALE, OFFSET)
    _, w, idx = cuda_fused.compact_interpolate_cuda(pts, coords, vfeats, vmask, occupancy,
                                                    unit_s, off_c)
    g = (rng.randn(b, N, C) * 10.0 ** rng.randint(-3, 4, size=(b, N, 1))).astype(np.float32)
    return _t(g), w, idx, coords, vmask


def _serial_rows(g, w, idx, v):
    """dfeats[b, idx[b, k, t]] += w[b, k, t] * g[b, t] in ascending e = k * N + t
    from 0, in numpy float32: each product, then each sum, rounded once."""
    b, n, c = g.shape
    out = np.zeros((b, v, c), np.float32)
    for bi in range(b):
        for e in range(3 * n):
            k, t = divmod(e, n)
            s = idx[bi, k, t]
            out[bi, s] = out[bi, s] + w[bi, k, t] * g[bi, t]
    return out


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


@pytest.mark.parametrize("cap", [300, 64])  # 64 < 200: sample 3 overflows
@pytest.mark.parametrize("kernel", ["K4", "K7"])
def test_plain_backward_is_the_serial_sum_in_entry_order(kernel, cap):
    g, w, idx, coords, vmask = _inputs(cap, seed=cap)
    gn, wn, idn = g.numpy(), w.numpy(), idx.numpy()
    rows = _serial_rows(gn, wn, idn, cap)
    # the cases are there: a hot slot, a missing neighbour (index 0 at
    # weight ~0), an empty sample whose contributions all go to its slot 0
    assert np.bincount(idn[0].ravel()).max() >= 200
    assert (idn[1] == 0).any() and not (vmask[2] > 0).any() and (idn[2] == 0).all()
    if kernel == "K4":
        got = cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap).numpy()
        want = rows
    else:
        got = cuda_fused.compact_interpolate_bwd_cuda(g, w, idx, coords, vmask,
                                                      (D, D, D)).numpy()
        # each valid slot's row at its cell; invalid slots' rows dropped
        want = np.zeros((len(OCCUPANCY), D, D, D, C), np.float32)
        valid = vmask.numpy() > 0
        for bi in range(len(OCCUPANCY)):
            xyz = coords.numpy()[bi][valid[bi]]
            want[bi, xyz[:, 0], xyz[:, 1], xyz[:, 2]] = rows[bi][valid[bi]]
        assert valid[3].sum() == min(cap, OCCUPANCY[3])
        assert not want[2].any()  # the empty sample's contributions are dropped
    # bit for bit, signs of zero included
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert cuda_interp.bwd_launches == cuda_fused.bwd_launches == 0


def _numpy_csr(idx, v):
    """Per sample, the entries e of idx [B, 3, N] grouped by slot in ascending
    e (slots outside [0, v) last), and the offsets start [B, v + 1]."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    start = np.zeros((b, v + 1), np.int32)
    ent = np.zeros(flat.shape, np.int32)
    for bi in range(b):
        groups = [[e for e in range(flat.shape[1]) if flat[bi, e] == s] for s in range(v)]
        rest = [e for e in range(flat.shape[1]) if not 0 <= flat[bi, e] < v]
        start[bi, 1:] = np.cumsum([len(x) for x in groups])
        ent[bi] = sum(groups, []) + rest
    return start, ent


@pytest.mark.parametrize("case", ["main", "hot", "out_of_range"])
def test_inverse_index_plain_is_the_stable_csr(case):
    rng = np.random.RandomState(3)
    v = 40
    idx = rng.randint(0, v, size=(3, 3, N))
    if case == "hot":
        idx[0] = 7                                     # one slot takes all 3N entries
        idx[1, :, : N // 2] = v - 1                    # and the last slot half of them
    elif case == "out_of_range":
        idx[0, 1, :10] = v                             # dropped past start[v]
        idx[2, 0, 5:9] = -1
    idx = idx.astype(np.int32)
    start, ent = cuda_interp.inverse_index_cuda(_t(idx), v)  # the plain version on the CPU
    assert start.dtype == ent.dtype == torch.int32
    want_start, want_ent = _numpy_csr(idx, v)
    np.testing.assert_array_equal(start.numpy(), want_start)
    np.testing.assert_array_equal(ent.numpy(), want_ent)
    assert cuda_interp.index_launches == 0


@pytest.mark.parametrize("b,cells,c,tile", [
    (32, 32 ** 3, 32, 128),  # level 0: K5's 16 KB tiles
    (32, 16 ** 3, 64, 64),
    (32, 8 ** 3, 128, 8),    # then fewer cells, for at least 2048 blocks
    (32, 4 ** 3, 256, 1),
    (1, 10, 7, 1),
])
def test_fused_backward_tiles(b, cells, c, tile):
    assert cuda_fused.bwd_tile(b, cells, c) == tile
    assert tile <= cuda_compact.bwd_tile(c)
    blocks = b * -(-cells // tile)
    assert blocks >= min(cuda_fused.BWD_MIN_BLOCKS, b * cells)


@pytest.mark.parametrize("c,rows", [(32, 8), (64, 4), (128, 2), (256, 1), (7, 36)])
def test_writer_rows(c, rows):
    # one thread a (row, channel), 256 a block: K4's rows per block
    assert cuda_interp.writer_rows(c) == rows
    assert rows * c <= cuda_interp.WRITER_THREADS < (rows + 1) * c


def test_index_scratch_and_point_limit():
    # start [B, V + 1] then ent [B, 3N]: 32 * (2049 + 3072) words at level 0
    assert cuda_interp.index_scratch_words(32, 1024, 2048) == 32 * 5121
    assert cuda_interp.index_scratch_words(2, 0, 5) == 12
    # one block sorts a sample's 3N entries, up to 6144: the configs' 1024 fit
    assert cuda_interp.MAX_POINTS == 2048


def test_backward_wrappers_refuse_non_cpu_tensors():
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_interp.inverse_index_cuda(torch.empty(2, 3, N, **i32), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_interp.nn_interpolate_bwd_cuda(
            torch.empty(2, N, 4, **meta), torch.empty(2, 3, N, **meta),
            torch.empty(2, 3, N, **i32), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fused.compact_interpolate_bwd_cuda(
            torch.empty(2, N, 4, **meta), torch.empty(2, 3, N, **meta),
            torch.empty(2, 3, N, **i32), torch.empty(2, 16, 3, **i32),
            torch.empty(2, 16, **meta), (8, 8, 8))
    assert cuda_interp.index_launches == cuda_interp.bwd_launches == 0
    assert cuda_fused.bwd_launches == 0
