"""The FLOP and byte counters against counts made by hand on a 16^3 grid."""

import pytest
import torch

from gpu_bench.counts import work
from gpu_bench.counts.peaks import PEAK_BYTES, PEAK_F32, bound


def _one_voxel(at=(8, 8, 8)):
    vidx = torch.tensor([[list(at)] * 4], dtype=torch.int32)  # 4 points, one voxel
    return vidx, work.input_mask(vidx, (16, 16, 16))


def test_a_corner_voxel_counts_every_layer_by_hand():
    """One occupied voxel at the corner of a 16^3 grid. Per axis, a regular
    conv grows a set {0..k} to {0..k+1} (clipped at the edge); a pool keeps
    cell i where 2i-1..2i+1 meets the set. Pairs per axis are the sums of
    each output's active neighbours: {0} -> {0,1}: 1+1 (cubed: 8);
    {0,1} subm: 2+2 (64); {0,1} -> {0,1,2}: 2+2+1 (125); {0,1,2} subm:
    2+3+2 (343)."""
    _, mask = _one_voxel((0, 0, 0))
    c = work.branch_counts(mask)
    pairs = (8, 64, 125, 343, 125, 343, 64, 64)
    d = work.DIMS
    expect = sum(2 * d[i] * d[i + 1] * p for i, p in enumerate(pairs))
    assert float(c["conv_flops"][0]) == expect
    assert [float(o[0]) for o in c["occupancy"]] == [8.0, 8.0, 8.0, 1.0]
    assert c["level_shapes"] == [(8, 8, 8), (4, 4, 4), (2, 2, 2), (1, 1, 1)]


def test_a_centre_voxel_pools_into_27_cells():
    """At the centre the set grows on both sides: the cube 7..9 after the
    first module lies in the windows of cells 3..5 of each axis."""
    _, mask = _one_voxel((8, 8, 8))
    assert float(work.branch_counts(mask)["occupancy"][0][0]) == 27.0


def test_head_flops_by_hand():
    n = m = 2
    dis = 2 * (480 * 256 + 256 * 256) * 2 + 2 * (480 * 256 + 256 * 64) * 2
    expect = n * dis + m * dis
    expect += 2 * n * m * (64 + 256 + 64) * 2
    expect += (n + m) * 2 * (256 * 256 + 256 * 128 + 128 * 3)
    expect += (n + m) * 2 * (128 * 128 + 128 * 128 + 128 * 1)
    expect += (n + m) * 2 * (512 * 512 + 512 * 512 + 512 * 1024)
    expect += 2 * (1024 * 512 + 512 * 128 + 128 * 9) + 2 * (1024 * 512 + 512 * 128 + 128 * 3)
    assert work.head_flops(n, m, template_heads=True) == expect
    assert work.head_flops(n, m, template_heads=False) == expect - m * dis


def test_kernel_bytes_by_hand():
    vidx, mask = _one_voxel()
    counts = work.branch_counts(mask)
    counts["multi_voxels"] = work.multi_voxels(vidx, (16, 16, 16))
    assert counts["multi_voxels"] == 1.0
    ks = work.kernel_bytes_flops(1, 4, 7, (16, 16, 16), counts, (64, 32, 16, 8), True)
    k1 = ks[0]
    # K1: the points' features and indices in, the grid and counts out;
    # one add per point and channel, one divide per channel of the voxel
    assert k1["bytes"] == 1 * 4 * (7 + 3) * 4 + 4096 * (7 + 1) * 4
    assert k1["flops"] == 4 * 8 + 1 * 7
    k2 = ks[1]  # level 0: 8^3 cells, 32 channels, 27 occupied, capacity 64
    assert k2["kernel"] == "K2"
    assert k2["bytes"] == 512 * 4 + 27 * 32 * 4 + 64 * (32 + 4) * 4 + 4
    k3 = ks[2]
    assert k3["bytes"] == (4 * 3 + 27 * (3 + 1 + 32) + 1 + 4 * 32 + 2 * 3 * 4) * 4
    assert k3["flops"] == 8 * 4 * 27 + 5 * 4 * 32
    assert [k["kernel"] for k in ks[:6]] == ["K1", "K2", "K3", "K4", "K5", "K2"]


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bound(PEAK_BYTES, 0.0) == pytest.approx((1.0, "bytes"))
    assert bound(0.0, PEAK_F32) == pytest.approx((1.0, "operations"))
