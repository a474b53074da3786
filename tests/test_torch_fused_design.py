"""The design of the fused compaction -> interpolation kernel K6, modelled on
the CPU, against the plain K6 that the kernel is held to on the card
(dcl_net_tpu_torch/csrc/fused.cu, three_nn_lanes.cuh).

- K6 runs K3's kernel with K2's int32 coords as its rows: the tile holds
  the coords' bits, and the block decodes each word in place with one
  rounded product and one rounded sum on its axis. Over every coordinate of
  a 64^3 grid and the four levels' constants, the model gives the centers
  the plain K6 forms, bit for bit; a fused multiply-add would not.
- K6 passes the occupancy as K3's n_valid: the split-scan model of
  tests/test_torch_interp_compact_design.py, fed the decoded centers and
  only the rows [0, min(occupancy, cap)), selects the plain K6's indices,
  on K2's output of a 16^3 grid (with overflow, an empty sample and one
  with 2 occupied voxels) and on a tie lattice in coords form.
- The plain K6 matches the JAX package's fused Pallas op (interpret mode)
  where its aligned layout does not overflow: idx (as voxels), out and w.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.ops import pallas_fused
from dcl_net_tpu.ops.pallas_compact import capacity_overflow, compact_raw
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.models.backbone import MultiScalePointFeatures
from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp
from dcl_net_tpu_torch.ops.sparse_conv import voxel_center_affine
from tests.test_torch_interp_compact_design import split_scan_idx
from tests.test_torch_train_ops import _occupied_grid

torch.set_num_threads(2)

D = 16


def decode_tile(coords: np.ndarray, unit_s, off_c) -> np.ndarray:
    """K6's in-tile decode of int32 coords [..., 3]: the shared-memory tile
    holds the words' bits (f32), each is read back as int32, converted
    (exact below 2^24), multiplied by unit_s[a] and added to off_c[a],
    a = the word's index mod 3, each step rounded to f32."""
    tile = np.ascontiguousarray(coords, np.int32).reshape(-1).view(np.float32)
    words = tile.view(np.int32)
    axis = np.arange(words.size) % 3
    prod = words.astype(np.float32) * np.asarray(unit_s, np.float32)[axis]
    return (prod + np.asarray(off_c, np.float32)[axis]).reshape(coords.shape)


def plain_centers(coords, unit_s, off_c, monkeypatch) -> torch.Tensor:
    """The centers that the plain K6 forms and hands to the plain K3."""
    seen = []
    real = cuda_interp.nn_interpolate_reference

    def spy(points, centers, feats, mask, n_valid=None):
        seen.append(centers)
        return real(points, centers, feats, mask)

    monkeypatch.setattr(cuda_interp, "nn_interpolate_reference", spy)
    b, v = coords.shape[:2]
    cuda_fused.compact_interpolate_reference(
        torch.zeros(b, 1, 3), coords, torch.zeros(b, v, 1), torch.ones(b, v),
        torch.full((b,), v, dtype=torch.int32), unit_s, off_c)
    monkeypatch.undo()
    (centers,) = seen
    return centers


def _level_affines():
    mcfg = Config.fromfile("configs/config_YCBV_bs32.yaml").model
    pf = MultiScalePointFeatures(tuple(mcfg.unit_voxel_extent),
                                 tuple(int(d) for d in mcfg.voxel_num_limit))
    return pf.center_affine


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_in_tile_decode_is_bit_equal_to_the_plain_centers(level, monkeypatch):
    unit_s, off_c = _level_affines()[level]
    axis = np.arange(64, dtype=np.int32)
    coords = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(1, -1, 3)
    got = decode_tile(coords, unit_s, off_c)
    want = plain_centers(torch.from_numpy(coords), unit_s, off_c, monkeypatch).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # one rounding of i * u + o (a fused multiply-add) gives other centers
    us = np.asarray(unit_s, np.float64)
    fma = (coords.astype(np.float64) * us + np.asarray(off_c, np.float64)).astype(np.float32)
    assert (fma != want).any()


def split_scan_n_valid(points, centers, mask, n_valid, lanes: int) -> torch.Tensor:
    """idx [B, 3, N] of the split scan over each sample's rows
    [0, max(0, min(n_valid[b], cap)))."""
    cap = centers.shape[1]
    rows = []
    for bi in range(points.shape[0]):
        nv = max(0, min(int(n_valid[bi]), cap))
        rows.append(split_scan_idx(points[bi:bi + 1], centers[bi:bi + 1, :nv],
                                   mask[bi:bi + 1, :nv], lanes))
    return torch.cat(rows)


def _grid_inputs(cap: int):
    """K2's plain output on a 16^3 grid: ~10 % occupied, then sample 1
    empty and sample 2 with 2 occupied voxels; points in the grid's box."""
    rng = np.random.RandomState(cap)
    mask = (rng.rand(4, D, D, D) > 0.9).astype(np.float32)
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2].reshape(-1)[[17, 2000]] = 1.0
    feats = rng.randn(4, D, D, D, 4).astype(np.float32)
    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_reference(
        torch.from_numpy(feats), torch.from_numpy(mask), cap)
    unit = (0.024,) * 3
    offset = tuple(-0.5 * 0.024 * D * 2.0 for _ in range(3))
    unit_s, off_c = (tuple(map(float, a)) for a in voxel_center_affine(unit, 2.0, offset))
    points = torch.from_numpy(
        ((rng.rand(4, 48, 3) - 0.5) * 0.024 * D * 2.0).astype(np.float32))
    return points, coords, vfeats, vmask, occ, unit_s, off_c


def _lattice_inputs(cap: int = 256):
    """An 8 x 8 x 4 lattice as int32 coords with unit_s 0.25 and off_c 0
    (centers exact in f32): sample 0 in order, 1 shuffled, 2 each of 128
    coords twice, 3 the lattice with occupancy 300 > cap; queries on nodes,
    edge and face midpoints and cell centers (up to 8 tied)."""
    rng = np.random.RandomState(5)
    lat = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij"),
                   -1).reshape(-1, 3).astype(np.int32)
    coords = np.stack([lat, lat[rng.permutation(256)], np.repeat(lat[:128], 2, 0), lat])
    offs = np.asarray([[0, 0, 0], [0.125, 0, 0], [0.125, 0.125, 0], [0.125, 0.125, 0.125]],
                      np.float32)
    points = lat[rng.randint(0, 256, (4, 96))] * np.float32(0.25) + offs[rng.randint(0, 4, (4, 96))]
    occ = np.asarray([256, 256, 256, 300], np.int32)
    return (torch.from_numpy(points.astype(np.float32)), torch.from_numpy(coords),
            torch.from_numpy(rng.randn(4, cap, 4).astype(np.float32)), torch.ones(4, cap),
            torch.from_numpy(occ), (0.25,) * 3, (0.0,) * 3)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("inputs", ["grid, overflow", "grid", "tie lattice"])
def test_decode_then_split_scan_selects_the_plain_k6_indices(lanes, inputs):
    if inputs == "tie lattice":
        points, coords, vfeats, vmask, occ, unit_s, off_c = _lattice_inputs()
    else:
        points, coords, vfeats, vmask, occ, unit_s, off_c = _grid_inputs(
            64 if inputs == "grid, overflow" else 512)
    cap = coords.shape[1]
    assert bool((occ > cap).any()) == (inputs != "grid")
    centers = torch.from_numpy(decode_tile(coords.numpy(), unit_s, off_c))
    got = split_scan_n_valid(points, centers, vmask, occ, lanes)
    _, _, want = cuda_fused.compact_interpolate_reference(points, coords, vfeats, vmask, occ,
                                                          unit_s, off_c)
    assert torch.equal(got, want)
    if inputs == "tie lattice":  # it does tie: more than 3 at the 3rd distance
        d2 = ((points[:, :, None] - centers[:, None]) ** 2).sum(-1)
        third = torch.sort(d2, -1).values[..., 2:3]
        assert int(((d2 == third).sum(-1) > 1).sum()) > 50
    else:  # an empty sample (missing neighbours: index 0) and one with 2 voxels
        assert occ[1] == 0 and occ[2] == 2
        assert bool((want[1] == 0).all()) and bool((want[2, 2] == 0).all())


@pytest.mark.parametrize("occupancy", [(60, 150), (3, 240)])
def test_plain_k6_matches_jax_fused_pallas(occupancy):
    rng = np.random.RandomState(sum(occupancy))
    c, cap = 8, 256
    feats, mask = _occupied_grid(rng, occupancy=occupancy, d=D, c=c)
    assert not bool(capacity_overflow(jnp.asarray(mask), cap).any())
    pts = ((rng.rand(len(occupancy), 128, 3) - 0.5) * 0.7).astype(np.float32)
    unit, scale = (0.024,) * 3, 2.0
    offset = tuple(-0.5 * 0.024 * D * scale for _ in range(3))
    us = tuple(u * scale for u in unit)
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(pts), cap, us, offset)
    j_out, j_w, j_idx = jax.jit(pallas_fused._fused_fwd, static_argnums=(3, 4, 5))(*args)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(pallas_fused.pallas_compact_interpolate,
                           static_argnums=(3, 4, 5))(*args)), np.asarray(j_out))
    # the Pallas idx indexes the raw rows (8-aligned gaps included): the
    # voxel of a row is its linear-index channels
    raw, _ = compact_raw(jnp.asarray(feats), jnp.asarray(mask), cap)
    raw = np.asarray(raw)
    j_lin = np.take_along_axis(raw[:, :, c] * 128 + raw[:, :, c + 1],
                               np.asarray(j_idx).reshape(len(occupancy), -1), 1)

    coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_reference(
        torch.from_numpy(feats), torch.from_numpy(mask), cap)
    unit_s, off_c = (tuple(map(float, a)) for a in voxel_center_affine(unit, scale, offset))
    out, w, idx = cuda_fused.compact_interpolate_reference(
        torch.from_numpy(pts), coords, vfeats, vmask, occ, unit_s, off_c)
    cell = torch.gather(coords.long(), 1, idx.long().reshape(len(occupancy), -1, 1).expand(
        -1, -1, 3))
    lin = ((cell[..., 0] * D + cell[..., 1]) * D + cell[..., 2]).numpy()
    np.testing.assert_array_equal(lin, j_lin.astype(np.int64))
    # the same centers and distances up to the affine constants' rounding;
    # the Pallas weighted sum is a one-hot matmul: 2e-5, as
    # tests/test_torch_fused.py holds the exact path
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=2e-5)
