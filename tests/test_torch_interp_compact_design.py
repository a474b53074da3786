"""The designs of the main path's 3-NN interpolation (K3) and compaction (K2)
kernels, modelled in torch on the CPU, against the plain versions that the
kernels are held to on the card (dcl_net_tpu_torch/csrc/interp.cu,
three_nn_lanes.cuh, compact.cu).

- K3 splits each query's scan over S lanes: lane s scans centers s, s + S,
  ... in ascending index with a strict-< top 3, then the lanes merge by a
  butterfly of (d, j)-lexicographic insertions (the R queries a lane scans
  at once do not change what each one selects). The model gives the plain
  version's indices, ties and missing neighbours included.
- K3's n_valid bounds the rows scanned; on the model's inputs and through
  the wrapper it changes nothing, and the wrapper checks its type.
- K2 counts each tile's occupied cells, sums the counts of the tiles
  before a tile, and ranks the tile's cells by a scan of 4-cell thread
  counts within 32-thread warps; the model equals the plain compaction,
  every element written, bit for bit in the valid rows.
- The two-stage point features, with K2's occupancy passed to K3, still
  match the JAX package.
"""

import numpy as np
import jax
import pytest
import torch

from dcl_net_tpu_torch.ops import cuda_compact, cuda_interp
from tests.test_torch_model import N, setup  # noqa: F401  (setup: the module fixture)

torch.set_num_threads(2)

GRID = (16, 16, 16)


# ------------------------------------------------------------ K3: the split scan
def _sq_dist(points, centers):
    """[B, N, V] squared distances as the kernel and the plain version form
    them: direct differences, (x^2 + y^2) + z^2."""
    sq = (points[:, :, None, :] - centers[:, None, :, :]) ** 2
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _push(top_d, top_j, d, j, take):
    """Insert (d, j) into sorted top-3 lists [..., 3] where `take` holds,
    ordered by (d, j): strict < on d, then j."""
    before = (d[..., None] < top_d) | ((d[..., None] == top_d) & (j[..., None] < top_j))
    before &= take[..., None]
    pos = 3 - before.sum(-1)  # the insertion slot, 3: not kept
    new_d, new_j = top_d.clone(), top_j.clone()
    for k in range(3):
        shift = pos <= k - 1  # slots after the insertion move one down
        if k > 0:
            new_d[..., k] = torch.where(shift, top_d[..., k - 1], top_d[..., k])
            new_j[..., k] = torch.where(shift, top_j[..., k - 1], top_j[..., k])
        at = pos == k
        new_d[..., k] = torch.where(at, d, new_d[..., k])
        new_j[..., k] = torch.where(at, j, new_j[..., k])
    return new_d, new_j


def lane_of(v: int, lanes: int) -> torch.Tensor:
    """The lane that scans each of v centers: center j to lane j % lanes."""
    return torch.arange(v) % lanes


def split_scan_idx(points, centers, mask, lanes: int):
    """idx [B, 3, N] of K3's split scan with `lanes` lanes a query."""
    d2 = _sq_dist(points, centers)
    b, n, v = d2.shape
    top_d = torch.full((b, n, lanes, 3), float("inf"))
    top_j = torch.full((b, n, lanes, 3), -1, dtype=torch.long)
    owner = lane_of(v, lanes)
    for j in range(v):  # each lane's share in ascending j: a strict-< scan
        s = int(owner[j])
        d = d2[:, :, j]
        keep = (mask[:, j] > 0)[:, None] & (d < top_d[:, :, s, 2])
        top_d[:, :, s], top_j[:, :, s] = _push(top_d[:, :, s], top_j[:, :, s], d,
                                               torch.full_like(d, j, dtype=torch.long), keep)
    lane = torch.arange(lanes)
    off = lanes // 2
    while off:  # the butterfly merge: each lane inserts its partner's three
        partner = lane ^ off
        pd, pj = top_d[:, :, partner], top_j[:, :, partner]
        for k in range(3):
            top_d, top_j = _push(top_d, top_j, pd[..., k], pj[..., k],
                                 torch.ones_like(pj[..., k], dtype=torch.bool))
        off //= 2
    assert torch.equal(top_j, top_j[:, :, :1].expand_as(top_j))  # every lane agrees
    idx = top_j[:, :, 0]
    idx = torch.where(idx < 0, torch.zeros_like(idx), idx)  # fill_missing
    return idx.transpose(1, 2).to(torch.int32)


def _lattice_inputs(rng):
    """256 centers on an 8 x 8 x 4 lattice of spacing 0.25: sample 0 in
    order, sample 1 shuffled, sample 2 each of 128 centers twice; queries
    on nodes, edge and face midpoints and cell centers (up to 8 tied)."""
    lat = (np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij"),
                    -1).reshape(-1, 3) * 0.25).astype(np.float32)
    centers = np.stack([lat, lat[rng.permutation(256)], np.repeat(lat[:128], 2, 0)])
    offs = np.asarray([[0, 0, 0], [0.125, 0, 0], [0.125, 0.125, 0], [0.125, 0.125, 0.125]],
                      np.float32)
    points = lat[rng.randint(0, 256, (3, 96))] + offs[rng.randint(0, 4, (3, 96))]
    return points, centers, np.ones((3, 256), np.float32)


def _few_valid_inputs(rng):
    """Samples with 0, 1, 2 and 3 valid centers among 43."""
    mask = np.zeros((4, 43), np.float32)
    for bi, k in enumerate((0, 1, 2, 3)):
        mask[bi, rng.choice(43, k, replace=False)] = 1.0
    return (rng.rand(4, 50, 3).astype(np.float32), rng.rand(4, 43, 3).astype(np.float32),
            mask)


def _non_prefix_inputs(rng):
    """A random mask over 200 centers, coordinates on a coarse grid so that
    distances tie often."""
    centers = (rng.randint(0, 6, (2, 200, 3)) * 0.5).astype(np.float32)
    points = (rng.randint(0, 12, (2, 80, 3)) * 0.25).astype(np.float32)
    return points, centers, (rng.rand(2, 200) > 0.5).astype(np.float32)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("inputs", [_lattice_inputs, _few_valid_inputs, _non_prefix_inputs])
def test_split_scan_model_selects_the_plain_versions_neighbours(lanes, inputs):
    points, centers, mask = (torch.from_numpy(a) for a in inputs(np.random.RandomState(3)))
    feats = torch.zeros(points.shape[0], centers.shape[1], 4)
    _, _, want = cuda_interp.nn_interpolate_reference(points, centers, feats, mask)
    got = split_scan_idx(points, centers, mask, lanes)
    assert torch.equal(got, want)
    if inputs is _lattice_inputs:  # the lattice does tie: more than 3 at the 3rd distance
        d2 = _sq_dist(points, centers)
        third = torch.sort(d2, -1).values[..., 2:3]
        assert int(((d2 == third).sum(-1) > 1).sum()) > 50


# ------------------------------------------------------------ K3: n_valid
def _compacted(rng, cap):
    mask = (rng.rand(3, *GRID) > 0.97).astype(np.float32)
    mask[1] = 0.0  # an empty sample
    feats = rng.randn(3, *GRID, 8).astype(np.float32)
    return cuda_compact.dense_to_sparse(torch.from_numpy(feats), torch.from_numpy(mask), cap)


@pytest.mark.parametrize("cap", [64, 256])  # 64: below the occupancy (overflow)
def test_n_valid_of_the_occupancy_changes_nothing(cap):
    rng = np.random.RandomState(cap)
    coords, vfeats, vmask, occ = _compacted(rng, cap)
    assert bool((occ > cap).any()) == (cap == 64)
    n_valid = torch.clamp(occ, max=cap)
    # the precondition: the mask is 0 from n_valid on
    assert torch.equal(vmask > 0, torch.arange(cap)[None] < n_valid[:, None])
    points = torch.from_numpy(rng.rand(3, 70, 3).astype(np.float32)) * 16
    centers = coords.to(torch.float32) + 0.5
    vfeats = vfeats.clone().requires_grad_(True)
    with_nv = cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask, n_valid)
    without = cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask)
    for a, b in zip(with_nv, without):
        assert torch.equal(a, b)
    # the differentiable entry point, with K2's occupancy as the backbone passes it
    g = torch.from_numpy(rng.randn(3, 70, 8).astype(np.float32))
    grads = []
    for nv in (occ, None):
        out = cuda_interp.nn_interpolate(points, centers, vfeats, vmask, nv)
        assert torch.equal(out, without[0])
        grads.append(torch.autograd.grad(out, vfeats, g)[0])
    assert torch.equal(grads[0], grads[1])
    assert cuda_interp.launches == 0


@pytest.mark.parametrize("bad, match", [
    (torch.zeros(3, dtype=torch.int64), "n_valid must be int32 \\[3\\]"),
    (torch.zeros(4, dtype=torch.int32), "n_valid must be int32 \\[3\\]"),
    (torch.zeros(3, 1, dtype=torch.int32), "n_valid must be int32 \\[3\\]"),
    (torch.zeros(6, dtype=torch.int32)[::2], "n_valid must be contiguous"),
    (torch.zeros(3, dtype=torch.int32, device="meta"), "different devices"),
])
def test_n_valid_is_checked(bad, match):
    points, centers = torch.zeros(3, 5, 3), torch.zeros(3, 4, 3)
    feats, mask = torch.zeros(3, 4, 2), torch.ones(3, 4)
    with pytest.raises(ValueError, match=match):
        cuda_interp.nn_interpolate_cuda(points, centers, feats, mask, bad)
    with pytest.raises(ValueError, match=match):
        cuda_interp.nn_interpolate(points, centers, feats, mask, bad)


# ------------------------------------------------------------ K2: tiles
def tiled_compaction(feats, mask, cap: int, tile: int):
    """K2's two kernels over (tiles of `tile` cells, B) blocks of tile / 4
    threads, 4 cells a thread, as torch: the per-tile counts, then each
    tile's offset (the counts of the tiles before it) and in-tile ranks (a
    warp-inclusive scan of the thread counts, plus the exclusive scan of the
    warp totals), the rows of rank < cap, and the tail [min(occupancy, cap),
    cap) shared out over the tiles. The outputs start as NaN / -1, so an
    element no block writes shows."""
    b, d0, d1, d2, c = feats.shape
    g = d0 * d1 * d2
    tiles = -(-g // tile)
    occ = torch.zeros(b, tiles * tile, dtype=torch.bool)
    occ[:, :g] = mask.reshape(b, g) > 0
    counts = occ.reshape(b, tiles, tile).sum(-1)                   # kernel 1
    before = torch.cumsum(counts, 1) - counts                      # kernel 2 from here
    total = counts.sum(1)
    own = occ.reshape(b, tiles, tile // 128, 32, 4).sum(-1)        # [B, T, warps, lanes]
    incl = torch.cumsum(own, -1)
    warp_incl = torch.cumsum(incl[..., -1], -1)
    thread_first = (before[:, :, None, None] + (warp_incl - incl[..., -1])[..., None]
                    + incl - own)
    in_thread = torch.cumsum(occ.reshape(b, tiles, tile // 128, 32, 4).long(), -1)
    rank = (thread_first[..., None] + in_thread - 1).reshape(b, -1)
    coords = torch.full((b, cap, 3), -1, dtype=torch.int32)
    vfeats = torch.full((b, cap, c), float("nan"))
    vmask = torch.full((b, cap), float("nan"))
    flat = feats.reshape(b, g, c)
    for bi in range(b):
        cells = torch.nonzero(occ[bi]).reshape(-1)
        r = rank[bi, cells]
        keep = r < cap
        cells, r = cells[keep], r[keep]
        coords[bi, r] = torch.stack([cells // (d1 * d2), cells % (d1 * d2) // d2, cells % d2],
                                    -1).to(torch.int32)
        vfeats[bi, r] = flat[bi, cells]
        vmask[bi, r] = 1.0
        nv = min(int(total[bi]), cap)
        share = -(-(cap - nv) // tiles)
        for t in range(tiles):
            lo = min(cap, nv + t * share)
            hi = min(cap, lo + share)
            coords[bi, lo:hi] = 0
            vfeats[bi, lo:hi] = 0.0
            vmask[bi, lo:hi] = 0.0
    return coords, vfeats, vmask, total.to(torch.int32)


@pytest.mark.parametrize("tile", [256, 512, 1024])
@pytest.mark.parametrize("case", ["overflow", "empty", "full", "tile edges"])
def test_tiled_compaction_model_is_bit_equal_to_the_plain_version(tile, case):
    rng = np.random.RandomState(tile)
    g = int(np.prod(GRID))
    feats = rng.randn(3, *GRID, 5).astype(np.float32)
    mask = (rng.rand(3, *GRID) > 0.9).astype(np.float32)
    cap = 256
    if case == "overflow":
        cap = 64  # below every sample's occupancy (about 410)
    elif case == "empty":
        mask[0] = 0.0
    elif case == "full":
        mask[1] = 1.0
        cap = g
    else:  # the cells on both sides of every tile edge, and the last cell
        flat = mask.reshape(3, g)
        flat[2] = 0.0
        for e in range(tile, g, tile):
            flat[2, e - 1:e + 1] = 1.0
        flat[2, g - 1] = 1.0
    ft, mt = torch.from_numpy(feats), torch.from_numpy(mask)
    got = tiled_compaction(ft, mt, cap, tile)
    want = cuda_compact.dense_to_sparse_reference(ft, mt, cap)
    # equal everywhere (no element left unwritten: NaN and -1 differ), and
    # bit for bit in the valid rows; the plain version's padding rows are
    # x * 0, -0.0 where x < 0, the kernel's (and the model's) +0.0
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and torch.equal(a, r)
    valid = want[2] > 0
    assert torch.equal(got[1][valid].view(torch.int32), want[1][valid].view(torch.int32))
    occ = want[3]
    if case == "overflow":
        assert bool((occ > cap).all())
    if case == "empty":
        assert int(occ[0]) == 0
    if case == "full":
        assert int(occ[1]) == g


# ------------------------------------------------------------ the two-stage path
def test_two_stage_features_with_the_occupancy_passed_match_jax(setup, monkeypatch):  # noqa: F811
    """The backbone passes each level's K2 occupancy to K3 as n_valid; the
    480-channel point features still match the JAX package's exact path as
    tests/test_torch_model.py holds them (1e-5)."""
    jmodel, variables, tmodel, batch, jbatch = setup
    seen = []
    real = cuda_interp.nn_interpolate_cuda

    def spy(points, centers, feats, mask, n_valid=None):
        seen.append((mask, n_valid))
        return real(points, centers, feats, mask, n_valid)

    monkeypatch.setattr(cuda_interp, "nn_interpolate_cuda", spy)

    def enc(m, f, i, side):
        return m._encode(m.backbone_inp, m.point_feats_inp, f, i, False)[1]

    jf = jax.jit(lambda v, f, i: jmodel.apply(v, f, i, "inp", method=enc))(
        variables, jbatch["inp"]["feats"], jbatch["inp"]["voxel_idx"])
    from dcl_net_tpu_torch.data.schema import batch_to_torch

    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        tf = tmodel._encode(tmodel.backbone_inp, tmodel.point_feats_inp,
                            tb["inp"]["feats"], tb["inp"]["voxel_idx"])[1]
    assert tf.shape == (2, N, 480)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    assert len(seen) == 4  # one K3 call a level, each given K2's occupancy
    for mask, n_valid in seen:
        assert n_valid is not None and n_valid.dtype == torch.int32
        assert torch.equal(torch.clamp(n_valid, max=mask.shape[1]), (mask > 0).sum(1).int())
