"""The port's host voxelizer (dcl_net_tpu_torch/ops/cpu_voxelizer.py).

Its native library (the port's copy of the root csrc/voxelizer.cpp, built
by g++ at first use) and its numpy versions (native=False) against the
JAX package's module on the same numpy-seeded coordinates and features:
voxelization_idx (slots in first-seen order), voxelization in modes 3 and
4 and point_recover, exact for the integer outputs and within 1e-6 for
the features. A compiler that is missing raises; importing the module
builds nothing (tests/test_torch_imports.py).
"""

import importlib
import shutil

import numpy as np
import pytest

from dcl_net_tpu.ops import cpu_voxelizer as jcv
from dcl_net_tpu_torch import host_build
from dcl_net_tpu_torch.ops import cpu_voxelizer as tcv

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on this host")


def _coords(seed, n=500):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(0, 3, (n, 1)), rng.randint(0, 6, (n, 3))],
                          -1).astype(np.int64)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_voxelization_idx_matches_jax(native):
    coords = _coords(0)
    got = tcv.voxelization_idx(coords, native=native)
    want = jcv.voxelization_idx(coords)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    out_coords, input_map, counts = got
    # first-seen order: the slot of each point's voxel rises with first sight
    first = [int(np.argmax(input_map == s)) for s in range(len(counts))]
    assert first == sorted(first)
    np.testing.assert_array_equal(out_coords[input_map], coords)


def test_voxelization_idx_capacity_maps_the_overflow_to_minus_one():
    coords = _coords(1)
    got = tcv.voxelization_idx(coords, capacity=10)
    assert got[0].shape == (10, 4) and (got[1] == -1).any()
    for g, w in zip(got, jcv.voxelization_idx(coords, capacity=10)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mode", [3, 4])
def test_voxelization_and_point_recover_match_jax(native, mode):
    coords = _coords(2)
    feats = np.random.RandomState(3).randn(len(coords), 5).astype(np.float32)
    _, input_map, counts = tcv.voxelization_idx(coords)
    got = tcv.voxelization(feats, input_map, counts, mode, native=native)
    want = jcv.voxelization(feats, input_map, counts, mode)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    back = tcv.point_recover(got, input_map, native=native)
    np.testing.assert_allclose(back, jcv.point_recover(want, input_map), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(back, got[input_map])
    dead = input_map.copy()
    dead[::7] = -1  # points without a slot add nothing and recover zeros
    np.testing.assert_array_equal(tcv.point_recover(got, dead, native=native)[::7], 0.0)
    np.testing.assert_allclose(tcv.voxelization(feats, dead, counts, 3, native=native),
                               tcv.voxelization(feats, dead, counts, 3, native=True),
                               rtol=1e-6, atol=1e-6)


def test_native_library_builds_from_the_ports_source(tmp_path):
    assert tcv.have_native()
    so = tcv.library_path()
    assert so.exists() and so.parent == host_build.BUILD_DIR
    with pytest.raises(RuntimeError, match="host voxelizer needs a C\\+\\+ compiler"):
        tcv.build(cxx="no-such-compiler-dclx", build_dir=tmp_path)
    assert not list(tmp_path.iterdir())
    # the module's library is the one the first call loaded
    assert importlib.import_module("dcl_net_tpu_torch.ops.cpu_voxelizer").library() is \
        tcv.library()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_slots_outside_the_voxels_raise_before_the_library_reads_them(native):
    feats = np.zeros((4, 2), np.float32)
    counts = np.ones(3, np.int32)
    with pytest.raises(ValueError, match="outside"):
        tcv.voxelization(feats, np.array([0, 1, 3, 2], np.int32), counts, native=native)
    with pytest.raises(ValueError, match="outside"):
        tcv.point_recover(np.zeros((3, 2), np.float32), np.array([0, -2, 1, 2], np.int32),
                          native=native)
    with pytest.raises(ValueError, match="shape"):
        tcv.voxelization(feats, np.array([0, 1], np.int32), counts, native=native)
