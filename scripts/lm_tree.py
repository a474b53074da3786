#!/usr/bin/env python3
"""Write a LineMOD and an Occlusion-LineMOD tree at full image size with
numpy, zlib, scipy and yaml only (no PIL): the layouts that
dcl_net_tpu_torch/data/linemod.py reads.

Usage:  python3 scripts/lm_tree.py OUT_DIR [--frames 8] [--repeats 5] [--lmo-images 5]

Writes under OUT_DIR (the --path_data of tools/test_lm.py and test_lmo.py):
  Linemod_preprocessed/models/obj_XX.ply     ASCII sphere meshes (mm, colors)
  Linemod_preprocessed/models/models_info.yml
  Linemod_preprocessed/data/XX/{rgb,depth,mask}/NNNN.png, gt.yml,
                                train.txt, test.txt
  Linemod_preprocessed/segnet_results/XX_label/NNNN_label.png
  OCCLUSION_LINEMOD/RGB-D/{rgb_noseg/color,depth_noseg/depth}_NNNNN.png
  OCCLUSION_LINEMOD/valid_poses/<name>/<i>.txt
  LMO_Masks/<name>/<i>.png

Each of the 13 LineMOD objects is a sphere 10-28 cm across (LineMOD's span
of object sizes), seen at 0.8-1.0 m by LineMOD's camera in `frames` frames
of 640 x 480: RGB8 color, gray16 depth in mm, RGB8 mask, gray8 SegNet
label (255 on the object). train.txt lists the frames once; test.txt lists
each frame `repeats` times, and the last frame's SegNet label is empty, so
the eval reader (every line of test.txt) gives 13 * frames * repeats rows
of which 13 * repeats are lost detections. Each Occlusion-LineMOD image
shows its 8 objects (LineMOD's meshes) on a 4 x 2 grid; every object has
`lmo_images * lmo_repeats` pose files over those images, its mask holds
its pixels that no object painted after it covers (the larger spheres
overlap), and every
`LMO_LOST_EVERY`-th one's mask is empty (a lost detection).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ycbv_tree import png_bytes  # noqa: E402

WIDTH, HEIGHT = 640, 480
CAM = dict(cx=325.26110, cy=242.04899, fx=572.41140, fy=573.57043)  # data/linemod.py
LM_OBJLIST = [1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]
LMO_ID2NAME = {1: "ape", 5: "can", 6: "cat", 8: "driller", 9: "duck",
               10: "eggbox", 11: "glue", 12: "holepuncher"}
FLIP = np.diag([1.0, -1.0, -1.0])  # data/linemod.py::ALIGNMENT_FLIPPING
MESH_POINTS = 600  # vertices of each sphere mesh (the readers sample 1024 surface points)
LMO_LOST_EVERY = 13


def diameters_mm() -> dict:
    """10-28 cm across, in LM_OBJLIST order."""
    return {obj: 100.0 + 15.0 * i for i, obj in enumerate(LM_OBJLIST)}


def _write_mesh(path: str, radius: float, rng: np.random.RandomState) -> None:
    from scipy.spatial import ConvexHull

    v = rng.randn(MESH_POINTS, 3)
    pts = radius * v / np.linalg.norm(v, axis=1, keepdims=True)
    faces = ConvexHull(pts).simplices
    cols = rng.randint(0, 256, (MESH_POINTS, 3))
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green", "property uchar blue",
             f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    lines += [f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}" for p, c in zip(pts, cols)]
    lines += [f"3 {f[0]} {f[1]} {f[2]}" for f in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _background(rng: np.random.RandomState) -> np.ndarray:
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    base = rng.randint(0, 256, (1, 1, 3))
    return (base + 40 * np.sin(xx / 37.0 + yy / 53.0)[..., None]
            + rng.randint(-20, 21, (HEIGHT, WIDTH, 3))).clip(0, 255).astype(np.uint8)


def _render_sphere(color, depth, center_mm, radius_mm, rng):
    """Paint a sphere's front surface into color and depth (mm): the first
    hit of each pixel's ray; returns the sphere's pixel mask."""
    c = np.asarray(center_mm, np.float64)
    u = CAM["cx"] + c[0] / c[2] * CAM["fx"]
    v = CAM["cy"] + c[1] / c[2] * CAM["fy"]
    r_pix = 1.5 * radius_mm / (c[2] - radius_mm) * max(CAM["fx"], CAM["fy"]) + 4
    rows = slice(max(int(v - r_pix), 0), min(int(v + r_pix) + 1, HEIGHT))
    cols = slice(max(int(u - r_pix), 0), min(int(u + r_pix) + 1, WIDTH))
    yy, xx = np.mgrid[rows, cols].astype(np.float64)
    # the ray s * d, d = ((x - cx) / fx, (y - cy) / fy, 1), meets the sphere
    # where |s d - c| = radius; its nearer root s is the depth
    d = np.stack([(xx - CAM["cx"]) / CAM["fx"], (yy - CAM["cy"]) / CAM["fy"],
                  np.ones_like(xx)], -1)
    dd, dc = (d * d).sum(-1), d @ c
    disc = dc ** 2 - dd * (c @ c - radius_mm ** 2)
    inside = disc > 0
    s = (dc - np.sqrt(np.maximum(disc, 0.0))) / dd
    mask = np.zeros((HEIGHT, WIDTH), bool)
    mask[rows, cols] = inside
    depth[rows, cols][inside] = np.round(s[inside]).astype(np.uint16)
    shade = rng.randint(0, 256, 3) + (yy[inside, None] - v) * 0.3
    color[rows, cols][inside] = shade.clip(0, 255).astype(np.uint8)
    return mask


def _bbox(mask: np.ndarray) -> list:
    ys, xs = np.nonzero(mask)
    return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min()), int(ys.max() - ys.min())]


def _write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(arr))


def write_lm_tree(out_dir: str, frames: int = 8, repeats: int = 5, seed: int = 0) -> dict:
    """The LineMOD tree; returns {"root", "train_rows", "eval_rows", "lost"}."""
    import yaml
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    root = os.path.join(out_dir, "Linemod_preprocessed")
    models = os.path.join(root, "models")
    os.makedirs(models, exist_ok=True)
    diam = diameters_mm()
    for obj in LM_OBJLIST:
        _write_mesh(os.path.join(models, f"obj_{obj:02d}.ply"), diam[obj] / 2, rng)
    with open(os.path.join(models, "models_info.yml"), "w") as f:
        yaml.safe_dump({obj: {"diameter": d} for obj, d in diam.items()}, f)

    for obj in LM_OBJLIST:
        d = os.path.join(root, "data", f"{obj:02d}")
        seg = os.path.join(root, "segnet_results", f"{obj:02d}_label")
        for sub in (os.path.join(d, "rgb"), os.path.join(d, "depth"), os.path.join(d, "mask"), seg):
            os.makedirs(sub, exist_ok=True)
        gt = {}
        names = [f"{k:04d}" for k in range(frames)]
        for k, name in enumerate(names):
            color = _background(rng)
            depth = np.zeros((HEIGHT, WIDTH), np.uint16)
            z = rng.uniform(800.0, 1000.0)
            center = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40), z])
            mask = _render_sphere(color, depth, center, diam[obj] / 2, rng)
            _write_png(f"{d}/rgb/{name}.png", color)
            _write_png(f"{d}/depth/{name}.png", depth)
            _write_png(f"{d}/mask/{name}.png", np.repeat(mask[..., None] * np.uint8(255), 3, 2))
            segnet = mask if k < frames - 1 else np.zeros_like(mask)  # the last: lost
            _write_png(f"{seg}/{name}_label.png", segnet.astype(np.uint8) * 255)
            entry = {"obj_id": obj,
                     "cam_R_m2c": Rotation.random(random_state=rng).as_matrix().ravel().tolist(),
                     "cam_t_m2c": center.tolist(), "obj_bb": _bbox(mask)}
            # scene 2 lists other objects' poses too: the reader picks obj_id 2
            gt[k] = ([{**entry, "obj_id": 1}, entry] if obj == 2 else [entry])
        with open(os.path.join(d, "gt.yml"), "w") as f:
            yaml.safe_dump(gt, f)
        with open(os.path.join(d, "train.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        with open(os.path.join(d, "test.txt"), "w") as f:
            f.write("\n".join(n for n in names for _ in range(repeats)) + "\n")
    n = len(LM_OBJLIST)
    return {"root": root, "train_rows": n * frames, "eval_rows": n * frames * repeats,
            "lost": n * repeats}


def write_lmo_tree(out_dir: str, images: int = 5, repeats: int = 13, seed: int = 1) -> dict:
    """The Occlusion-LineMOD tree over the LineMOD tree's meshes (write
    that first); returns {"root", "masks", "eval_rows", "lost"}."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    root = os.path.join(out_dir, "OCCLUSION_LINEMOD")
    masks_root = os.path.join(out_dir, "LMO_Masks")
    for sub in ("rgb_noseg", "depth_noseg"):
        os.makedirs(os.path.join(root, "RGB-D", sub), exist_ok=True)
    diam = diameters_mm()
    objs = list(LMO_ID2NAME)
    scenes = []
    for img_id in range(images):
        color = _background(rng)
        depth = np.zeros((HEIGHT, WIDTH), np.uint16)
        owner = np.zeros((HEIGHT, WIDTH), np.int32)  # the object painted last at a pixel
        centers = {}
        for j, obj in enumerate(objs):  # a 4 x 2 grid of cells; larger spheres overlap
            z = rng.uniform(800.0, 1000.0)
            u = (j % 4 + 0.5) * WIDTH / 4 + rng.uniform(-8, 8)
            v = (j // 4 + 0.5) * HEIGHT / 2 + rng.uniform(-8, 8)
            centers[obj] = np.array([(u - CAM["cx"]) * z / CAM["fx"],
                                     (v - CAM["cy"]) * z / CAM["fy"], z])
            owner[_render_sphere(color, depth, centers[obj], diam[obj] / 2, rng)] = obj
        placed = {obj: (centers[obj], owner == obj) for obj in objs}  # visible masks
        _write_png(os.path.join(root, "RGB-D", "rgb_noseg", f"color_{img_id:05d}.png"), color)
        _write_png(os.path.join(root, "RGB-D", "depth_noseg", f"depth_{img_id:05d}.png"), depth)
        scenes.append(placed)
    lost = 0
    for obj, name in LMO_ID2NAME.items():
        pose_dir = os.path.join(root, "valid_poses", name)
        mask_dir = os.path.join(masks_root, name)
        os.makedirs(pose_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        for i in range(images * repeats):
            img_id = i % images
            center, mask = scenes[img_id][obj]
            if i % LMO_LOST_EVERY == LMO_LOST_EVERY - 1:
                mask, lost = np.zeros_like(mask), lost + 1
            _write_png(os.path.join(mask_dir, f"{i}.png"), mask.astype(np.uint8))
            # the reader applies FLIP to the stored pose: store FLIP @ pose
            r = FLIP @ Rotation.random(random_state=rng).as_matrix()
            t = FLIP @ (center / 1000.0)
            with open(os.path.join(pose_dir, f"{i}.txt"), "w") as f:
                f.write("rotation:\n" + "".join(f"{a:.8f} {b:.8f} {c:.8f}\n" for a, b, c in r))
                f.write(f"center:\n{t[0]:.8f} {t[1]:.8f} {t[2]:.8f}\n{img_id}\n")
    return {"root": root, "masks": masks_root, "eval_rows": len(objs) * images * repeats,
            "lost": lost}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--lmo-images", type=int, default=5)
    parser.add_argument("--lmo-repeats", type=int, default=13)
    args = parser.parse_args()
    lm = write_lm_tree(args.out_dir, args.frames, args.repeats)
    lmo = write_lmo_tree(args.out_dir, args.lmo_images, args.lmo_repeats)
    print(f"LineMOD: {lm['eval_rows']} eval rows ({lm['lost']} lost), {lm['train_rows']} "
          f"train rows; Occlusion-LineMOD: {lmo['eval_rows']} rows ({lmo['lost']} lost)")


if __name__ == "__main__":
    main()
