"""ctypes binding of the host-side voxelizer (csrc/host/voxelizer.cpp).

Counterpart of dcl_net_tpu/ops/cpu_voxelizer.py: the reference's
collate-time CPU voxelization (pointgroup_ops.voxelization_idx,
voxelization and point_recover) on numpy arrays. The C++ source is the
port's own copy of the root csrc/voxelizer.cpp; it is built with a C++
compiler ($CXX, else g++) at first use into dcl_net_tpu_torch/build/
(host_build.py), never when this module is imported.

Unlike the JAX module, a library that fails to build raises, with the
compiler's output: nothing falls back quietly. The numpy versions of the
three functions are reached with native=False only (the tests hold the
library to them).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dcl_net_tpu_torch import host_build

SOURCES = ("voxelizer.cpp",)
STEM = "libdclx_voxelizer"


def library_path(build_dir: Path = host_build.BUILD_DIR) -> Path:
    return host_build.library_path(SOURCES, STEM, build_dir)


def build(cxx: str = None, build_dir: Path = host_build.BUILD_DIR) -> Path:
    """Compile the host voxelizer if it is missing and return its path
    (host_build.build; RuntimeError with the compiler's output)."""
    return host_build.build(SOURCES, STEM, "the host voxelizer", cxx=cxx,
                            build_dir=build_dir)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host voxelizer, built on first call (RuntimeError with the
    compiler's output when it cannot be)."""
    lib = ctypes.CDLL(str(build()))
    lib.voxelize_idx.restype = ctypes.c_int
    lib.voxelize_idx.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.voxelize_feats.restype = None
    lib.voxelize_feats.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.point_recover.restype = None
    lib.point_recover.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def have_native() -> bool:
    """Whether the host library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def voxelization_idx(coords: np.ndarray, capacity: Optional[int] = None,
                     native: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique-voxel map over [N, 4] (batch, x, y, z) int coords.

    Returns (output_coords [M, 4] int64, input_map [N] int32 point -> voxel
    slot, counts [M] int32), the slots in first-seen order, as the
    reference's hash map numbers them. native=False: the numpy version
    (stable first-seen unique; no capacity)."""
    coords = np.ascontiguousarray(coords, dtype=np.int64)
    n = coords.shape[0]
    if native:
        capacity = capacity or n
        input_map = np.empty(n, np.int32)
        out_coords = np.zeros((capacity, 4), np.int64)
        counts = np.zeros(capacity, np.int32)
        m = library().voxelize_idx(coords.ctypes.data, n, input_map.ctypes.data,
                                   out_coords.ctypes.data, counts.ctypes.data, capacity)
        return out_coords[:m], input_map, counts[:m]
    _, first_idx, inverse = np.unique(coords, axis=0, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    input_map = rank[inverse.reshape(-1)].astype(np.int32)
    m = len(order)
    out_coords = coords[np.sort(first_idx)]
    counts = np.bincount(input_map, minlength=m).astype(np.int32)
    return out_coords, input_map, counts


def _check_map(input_map: np.ndarray, n: int, m: int, what: str) -> None:
    """The library indexes slots unchecked: every entry of input_map must be
    a slot below m, or -1 (no slot), and there must be one per point."""
    if input_map.shape != (n,):
        raise ValueError(f"{what}: input_map of shape {input_map.shape} for {n} points")
    if n and (int(input_map.min()) < -1 or int(input_map.max()) >= m):
        raise ValueError(f"{what}: input_map holds slots outside [-1, {m})")


def voxelization(feats: np.ndarray, input_map: np.ndarray, counts: np.ndarray,
                 mode: int = 4, native: bool = True) -> np.ndarray:
    """Scatter point features [N, C] into the voxel slots: mode 4 the mean,
    else the sum. native=False: the numpy version."""
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    n, c = feats.shape
    m = len(counts)
    _check_map(np.asarray(input_map), n, m, "voxelization")
    out = np.zeros((m, c), np.float32)
    if native:
        counts32 = np.ascontiguousarray(counts, np.int32)
        imap = np.ascontiguousarray(input_map, np.int32)
        library().voxelize_feats(feats.ctypes.data, imap.ctypes.data, n, c,
                                 out.ctypes.data, counts32.ctypes.data, m, mode)
        return out
    keep = np.asarray(input_map) >= 0  # slot -1 adds nothing, as in the library
    np.add.at(out, np.asarray(input_map)[keep], feats[keep])
    if mode == 4:
        out /= np.maximum(counts[:, None], 1)
    return out


def point_recover(voxel_feats: np.ndarray, input_map: np.ndarray,
                  native: bool = True) -> np.ndarray:
    """Voxel features [M, C] back to the points (0 for a point of slot -1).
    native=False: the numpy version."""
    voxel_feats = np.ascontiguousarray(voxel_feats, dtype=np.float32)
    m, c = voxel_feats.shape
    n = len(input_map)
    _check_map(np.asarray(input_map), n, m, "point_recover")
    if native:
        out = np.empty((n, c), np.float32)
        imap = np.ascontiguousarray(input_map, np.int32)
        library().point_recover(voxel_feats.ctypes.data, imap.ctypes.data, n, c,
                                out.ctypes.data)
        return out
    return voxel_feats[np.clip(input_map, 0, m - 1)] * (input_map >= 0)[:, None]
