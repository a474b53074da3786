#!/usr/bin/env python3
"""Write a YCB-Video test tree at full image size with numpy, zlib and scipy
only (no PIL): the layout that dcl_net_tpu_torch/data/ycbv.py reads.

Usage:  python3 scripts/ycbv_tree.py OUT_DIR [--classes 21] [--frames 26]

Writes OUT_DIR/YCB_Video_Dataset/ with
  classes.txt, train_data_list.txt, test_data_list.txt,
  CADs/obj_XX_pc.ply         ASCII sphere clouds with colors,
  root/data/0001/NNNNNN-{color,depth,label}.png and -meta.mat,
  YCBV_Masks/Masks_FFB6D/NNNNNN.mat  (labels and rois of the detections).
Each 640 x 480 frame shows every class once, as a sphere on a grid of
cells (7 columns) in front of CAM_1; the color PNG is RGB8, the depth PNG
gray16 at 10000 units a metre, the label PNG gray8. One detection a frame
is left out of the masks' rois (a lost detection), so a frame holds
`classes` instances of which one is lost.

chip_smoke.py writes such a tree to drive the YCB-V eval CLIs on the card,
where PIL cannot be counted on; the tests check its PNGs against PIL.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np

WIDTH, HEIGHT = 640, 480
COLUMNS = 7
CAM_1 = dict(cx=312.9869, cy=241.3109, fx=1066.778, fy=1067.487)  # data/ycbv.py
DEPTH_SCALE = 10000.0
RADIUS = 0.025  # metres: a sphere a YCB object's size
CAD_POINTS = 2000  # points of each CAD cloud (the readers draw 1024 of them)
IDAT_BYTES = 1 << 16  # IDAT chunk size, as encoders split the stream


def png_bytes(arr: np.ndarray, level: int = 6) -> bytes:
    """PNG file of a [H, W] u8/u16 or [H, W, 3|4] u8 array, not interlaced.
    Row 0 is written with filter 0 (None), every later row with filter 2
    (Up), and the stream is split over IDAT chunks of IDAT_BYTES."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png_bytes: dtype {arr.dtype}")
    h, w = arr.shape[:2]
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = arr.astype(arr.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # mod 256, as filter 2 defines it
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 2
    raw[0, 0] = 0
    raw[:, 1:] = up
    stream = zlib.compress(raw.tobytes(), level)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * arr.itemsize, color_type, 0, 0, 0)
    idat = b"".join(chunk(b"IDAT", stream[i:i + IDAT_BYTES])
                    for i in range(0, len(stream), IDAT_BYTES))
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + idat + chunk(b"IEND", b"")


def _write_ply_ascii(path: str, pts: np.ndarray, colors: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def _render_frame(rng: np.random.RandomState, n_classes: int):
    """One frame: color, depth, label images and the [3, 4, n] poses."""
    from scipy.spatial.transform import Rotation

    rows_n = -(-n_classes // COLUMNS)
    cell_w, cell_h = WIDTH / COLUMNS, HEIGHT / rows_n
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    base = rng.randint(0, 256, (1, 1, 3))
    color = (base + 40 * np.sin(xx / 37.0)[..., None]
             + rng.randint(-20, 21, (HEIGHT, WIDTH, 3))).clip(0, 255).astype(np.uint8)
    depth = np.zeros((HEIGHT, WIDTH), np.uint16)
    label = np.zeros((HEIGHT, WIDTH), np.uint8)
    poses = np.zeros((3, 4, n_classes), np.float32)
    for k in range(n_classes):
        u = (k % COLUMNS + 0.5) * cell_w + rng.uniform(-5, 5)
        v = (k // COLUMNS + 0.5) * cell_h + rng.uniform(-5, 5)
        z = rng.uniform(0.85, 1.0)
        center = np.array([(u - CAM_1["cx"]) * z / CAM_1["fx"],
                           (v - CAM_1["cy"]) * z / CAM_1["fy"], z])
        # the sphere's front surface, z - sqrt(R^2 - rho^2), in a window
        # around its image (R / z * fx < 32 pixels)
        win = (slice(max(int(v) - 40, 0), int(v) + 41),
               slice(max(int(u) - 40, 0), int(u) + 41))
        rho2 = (((xx[win] - u) * z / CAM_1["fx"]) ** 2
                + ((yy[win] - v) * z / CAM_1["fy"]) ** 2)
        inside = rho2 < RADIUS ** 2
        surface = z - np.sqrt(np.maximum(RADIUS ** 2 - rho2, 0.0))
        depth[win][inside] = np.round(surface[inside] * DEPTH_SCALE).astype(np.uint16)
        label[win][inside] = k + 1
        color[win][inside] = rng.randint(0, 256, 3)
        poses[:, :3, k] = Rotation.random(random_state=rng).as_matrix()
        poses[:, 3, k] = center
    return color, depth, label, poses


def write_tree(out_dir: str, n_classes: int = 21, n_frames: int = 26,
               seed: int = 0) -> dict:
    """Write the tree; returns {"path_data", "root", "assets", "instances",
    "lost"}: path_data is the --path_data of the eval CLIs."""
    import scipy.io as sio

    if not 1 <= n_classes <= 3 * COLUMNS:
        raise ValueError(f"n_classes {n_classes}: 1 to {3 * COLUMNS} fit on the grid")
    rng = np.random.RandomState(seed)
    assets = os.path.join(out_dir, "YCB_Video_Dataset")
    root = os.path.join(assets, "root")
    cad_dir = os.path.join(assets, "CADs")
    masks_dir = os.path.join(assets, "YCBV_Masks", "Masks_FFB6D")
    for d in (os.path.join(root, "data", "0001"), cad_dir, masks_dir):
        os.makedirs(d, exist_ok=True)

    names = [f"obj_{k:02d}" for k in range(1, n_classes + 1)]
    with open(os.path.join(assets, "classes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for name in names:
        v = rng.randn(CAD_POINTS, 3)
        pts = RADIUS * v / np.linalg.norm(v, axis=1, keepdims=True)
        _write_ply_ascii(os.path.join(cad_dir, name + "_pc.ply"), pts,
                         rng.randint(0, 256, (CAD_POINTS, 3)))

    frames = [f"data/0001/{i + 1:06d}" for i in range(n_frames)]
    for list_name in ("train_data_list.txt", "test_data_list.txt"):
        with open(os.path.join(assets, list_name), "w") as f:
            f.write("\n".join(frames) + "\n")
    for i, frame in enumerate(frames):
        color, depth, label, poses = _render_frame(rng, n_classes)
        for suffix, img in (("color", color), ("depth", depth), ("label", label)):
            with open(f"{root}/{frame}-{suffix}.png", "wb") as f:
                f.write(png_bytes(img))
        sio.savemat(f"{root}/{frame}-meta.mat", {
            "cls_indexes": np.arange(1, n_classes + 1).reshape(-1, 1),
            "poses": poses,
            "factor_depth": np.array([[DEPTH_SCALE]]),
        })
        # FFB6D-style rois [_, cls, cmin, rmin, cmax, rmax]; class i % n is
        # not detected in frame i
        rois = []
        for k in range(n_classes):
            if k == i % n_classes:
                continue
            ys, xs = np.nonzero(label == k + 1)
            rois.append([0, k + 1, xs.min(), ys.min(), xs.max(), ys.max()])
        sio.savemat(os.path.join(masks_dir, f"{i:06d}.mat"),
                    {"labels": label, "rois": np.array(rois, np.float32)})
    return {"path_data": out_dir, "root": root, "assets": assets,
            "instances": n_classes * n_frames, "lost": n_frames}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--classes", type=int, default=21)
    parser.add_argument("--frames", type=int, default=26)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    info = write_tree(args.out_dir, args.classes, args.frames, args.seed)
    print(f"{info['instances']} instances ({info['lost']} lost) under {info['assets']}")


if __name__ == "__main__":
    main()
