"""Minimal PLY reader + mesh surface sampling (replaces open3d usage).

The port's own copy of dcl_net_tpu/data/ply.py. The reference reads CAD
clouds with open3d (YCBV/dataloader_train_YCBV.py:64,
LM/dataloader_train_LM.py:64-67 `sample_points_uniformly`); this module
provides the same capabilities dependency-free: ascii and
binary_little_endian PLY parsing of vertices (xyz + optional rgb) and faces,
plus area-weighted uniform surface sampling.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Parse a PLY file. Returns dict with "points" [N,3] float32, optional
    "colors" [N,3] float32 in [0,1], optional "faces" [F,3] int32."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        elements = []  # (name, count, [(prop_name, type) or ("__list__", idx_t, elem_t, name)])
        while True:
            line = f.readline().strip().decode("ascii", "replace")
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("__list__", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                if name == "vertex":
                    arr = np.array([[float(v) for v in r[: len(props)]] for r in rows])
                    out["__vertex_props"] = np.array([p[0] for p in props], dtype=object)
                    out["__vertex_data"] = arr
                elif name == "face":
                    out["faces"] = np.array(
                        [[int(v) for v in r[1:4]] for r in rows], np.int32
                    )
            else:
                assert fmt == "binary_little_endian", fmt
                if all(p[0] != "__list__" for p in props):
                    codes = "".join(_PLY_TYPES[p[1]][0] for p in props)
                    rec = struct.calcsize("<" + codes)
                    raw = f.read(rec * count)
                    arr = np.array(
                        [struct.unpack_from("<" + codes, raw, i * rec) for i in range(count)],
                        np.float64,
                    )
                    if name == "vertex":
                        out["__vertex_props"] = np.array([p[0] for p in props], dtype=object)
                        out["__vertex_data"] = arr
                else:
                    faces = []
                    for _ in range(count):
                        (n,) = struct.unpack(
                            "<" + _PLY_TYPES[props[0][1]][0], f.read(_PLY_TYPES[props[0][1]][1])
                        )
                        code = _PLY_TYPES[props[0][2]][0]
                        vals = struct.unpack("<" + code * n, f.read(_PLY_TYPES[props[0][2]][1] * n))
                        faces.append(vals[:3])
                    if name == "face":
                        out["faces"] = np.asarray(faces, np.int32)

    names = list(out.pop("__vertex_props", []))
    data = out.pop("__vertex_data", None)
    if data is not None:
        def col(keys):
            idx = [names.index(k) for k in keys if k in names]
            return data[:, idx] if len(idx) == len(keys) else None

        pts = col(["x", "y", "z"])
        assert pts is not None, "PLY has no x/y/z vertex properties"
        out["points"] = pts.astype(np.float32)
        rgb = col(["red", "green", "blue"])
        if rgb is not None:
            out["colors"] = (rgb / 255.0).astype(np.float32)
    return out


def sample_points_uniformly(
    points: np.ndarray,
    faces: np.ndarray,
    n: int,
    rng: Optional[np.random.RandomState] = None,
    colors: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Area-weighted uniform sampling on a triangle mesh
    (open3d sample_points_uniformly equivalent,
    used at reference LM/dataloader_train_LM.py:64-67)."""
    rng = rng or np.random.RandomState(0)
    v0, v1, v2 = (points[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    w0, w1, w2 = 1 - r1, r1 * (1 - r2), r1 * r2
    samples = w0 * points[faces[tri, 0]] + w1 * points[faces[tri, 1]] + w2 * points[faces[tri, 2]]
    out_colors = None
    if colors is not None:
        out_colors = (
            w0 * colors[faces[tri, 0]] + w1 * colors[faces[tri, 1]] + w2 * colors[faces[tri, 2]]
        ).astype(np.float32)
    return samples.astype(np.float32), out_colors
