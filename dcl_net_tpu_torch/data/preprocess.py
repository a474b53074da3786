"""Host-side preprocessing: bbox snapping, depth lift, augmentation, voxel prep.

The port's own copy of dcl_net_tpu/data/preprocess.py: a numpy
re-implementation of the reference dataloader math, so samples are
bit-compatible given the same RNG draws:
- get_bbox border snapping (reference YCBV/dataloader_train_YCBV.py:280-318)
- depth -> camera-frame point cloud lift (:146-154)
- centroid centering (:157-159)
- SE(3) train augmentation: +-5deg euler rotation of the object frame,
  +-3cm translation jitter (:161-177)
- volume filter + resample to fixed point count (:189-199)
- feature assembly [1, rgb - imagenet_mean, xyz] + voxel indices (:202-205)
- mask_to_bbox, the largest contour's box (reference LM/dataloader_test_LM.py:16-32),
  through scipy.ndimage instead of cv2
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)

BORDER_LIST = [-1, 40, 80, 120, 160, 200, 240, 280, 320, 360, 400, 440, 480,
               520, 560, 600, 640, 680]


def get_bbox(label_mask: np.ndarray, img_h: int = 480, img_w: int = 640
             ) -> Tuple[int, int, int, int]:
    """Snap the mask's bbox to the reference border ladder
    (reference YCBV/dataloader_train_YCBV.py:280-318)."""
    rows = np.any(label_mask, axis=1)
    cols = np.any(label_mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    rmax += 1
    cmax += 1
    r_b = rmax - rmin
    for tt in range(len(BORDER_LIST) - 1):
        if BORDER_LIST[tt] < r_b < BORDER_LIST[tt + 1]:
            r_b = BORDER_LIST[tt + 1]
            break
    c_b = cmax - cmin
    for tt in range(len(BORDER_LIST) - 1):
        if BORDER_LIST[tt] < c_b < BORDER_LIST[tt + 1]:
            c_b = BORDER_LIST[tt + 1]
            break
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
    rmin = center[0] - r_b // 2
    rmax = center[0] + r_b // 2
    cmin = center[1] - c_b // 2
    cmax = center[1] + c_b // 2
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_h:
        rmin -= rmax - img_h
        rmax = img_h
    if cmax > img_w:
        cmin -= cmax - img_w
        cmax = img_w
    return rmin, rmax, cmin, cmax


def mask_to_bbox(mask: np.ndarray, img_w: int = 640, img_h: int = 480
                 ) -> Tuple[int, int, int, int]:
    """Largest-contour bbox (reference LM/dataloader_test_LM.py:16-32).
    Returns (x, y, w, h).

    The reference takes cv2.findContours (RETR_TREE) and keeps the first
    contour, in cv2's order, whose boundingRect has the largest w * h. An
    outer contour bounds one 8-connected component of the nonzero pixels,
    and a hole's contour lies inside its component's box, so this is the
    largest box of the components; cv2 lists the components in reverse
    raster order of their first pixel, and so ties go to the last of them
    in raster order. scipy.ndimage stands in for cv2, so the port does not
    depend on OpenCV."""
    from scipy import ndimage

    labels, _ = ndimage.label(np.asarray(mask) != 0, structure=np.ones((3, 3), bool))
    x = y = w = h = 0
    for rows, cols in reversed(ndimage.find_objects(labels)):
        tw, th = cols.stop - cols.start, rows.stop - rows.start
        if tw * th > w * h:
            x, y, w, h = cols.start, rows.start, tw, th
    return x, y, min(w, img_w - x), min(h, img_h - y)


def depth_to_cloud(
    depth: np.ndarray,
    choose: np.ndarray,
    rmin: int, rmax: int, cmin: int, cmax: int,
    cam_cx: float, cam_cy: float, cam_fx: float, cam_fy: float,
    cam_scale: float,
) -> np.ndarray:
    """Lift chosen crop pixels to camera-frame 3D points
    (reference YCBV/dataloader_train_YCBV.py:146-154). NOTE the reference
    swaps the usual axes: xmap is the row index and ymap the column index."""
    h, w = depth.shape
    xmap = np.arange(h, dtype=np.float32)[:, None].repeat(w, axis=1)
    ymap = np.arange(w, dtype=np.float32)[None, :].repeat(h, axis=0)
    depth_masked = depth[rmin:rmax, cmin:cmax].flatten()[choose].astype(np.float32)
    xmap_masked = xmap[rmin:rmax, cmin:cmax].flatten()[choose]
    ymap_masked = ymap[rmin:rmax, cmin:cmax].flatten()[choose]
    pt2 = depth_masked / cam_scale
    pt0 = (ymap_masked - cam_cx) * pt2 / cam_fx
    pt1 = (xmap_masked - cam_cy) * pt2 / cam_fy
    return np.stack([pt0, pt1, pt2], axis=1)


def se3_augment(
    cloud: np.ndarray,
    target_r: np.ndarray,
    target_t: np.ndarray,
    rng: np.random.RandomState,
    angle_range: float = np.pi / 36.0,
    trans_range: float = 0.03,
    *,
    trans_rng,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SE(3) training augmentation (reference YCBV/dataloader_train_YCBV.py:
    161-177): rotate the object frame by a random +-5deg euler rotation and
    jitter the translation by +-3cm, transforming the observed cloud
    consistently.

    Draw-for-draw identical to the reference: three separate angle draws
    from `rng` (the reference's np.random.uniform calls), then three
    `trans_rng.uniform` translation jitters. `trans_rng` is REQUIRED and
    keyword-only because the two streams intentionally differ: the
    reference draws translations from the process-global PYTHON `random`
    module, so the datasets pass that module (bit-comparable same-seed
    samples, tests/test_golden_data.py); callers needing self-contained
    determinism pass a `random.Random` instance instead."""
    from scipy.spatial.transform import Rotation

    a = [rng.uniform(-angle_range, angle_range) for _ in range(3)]
    # transforms3d euler2mat(a1,a2,a3) default 'sxyz' == scipy extrinsic xyz
    aug_r = Rotation.from_euler("xyz", a).as_matrix().astype(np.float32)
    cloud_obj = (cloud - target_t) @ target_r  # canonicalize
    target_t = target_t + np.array(
        [trans_rng.uniform(-trans_range, trans_range) for _ in range(3)],
        np.float32,
    )
    target_r = (target_r @ aug_r).astype(np.float32)
    cloud = cloud_obj @ target_r.T + target_t
    return cloud.astype(np.float32), target_r, target_t


def filter_and_resample(
    cloud: np.ndarray,
    rgb: np.ndarray,
    total_extent: np.ndarray,
    n_points: int,
    rng: np.random.RandomState,
    min_points: int = 50,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Keep points inside the voxel volume and resample to n_points
    (reference YCBV/dataloader_train_YCBV.py:189-199). Returns None when too
    few points survive (sample flagged invalid)."""
    keep = (
        (np.abs(cloud[:, 0]) < total_extent[0] * 0.5)
        & (np.abs(cloud[:, 1]) < total_extent[1] * 0.5)
        & (np.abs(cloud[:, 2]) < total_extent[2] * 0.5)
    )
    if keep.sum() <= min_points:
        return None
    cloud = cloud[keep]
    rgb = rgb[keep]
    if cloud.shape[0] > n_points:
        sel = rng.choice(cloud.shape[0], n_points, replace=False)
    else:
        sel = rng.choice(cloud.shape[0], n_points)
    return cloud[sel], rgb[sel]


def assemble_features(
    cloud: np.ndarray,
    rgb: np.ndarray,
    unit_voxel_extent: np.ndarray,
    total_extent: np.ndarray,
    voxel_num_limit: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """[1, rgb, xyz] features + int voxel indices
    (reference YCBV/dataloader_train_YCBV.py:202-205). The reference uses
    total_extent[0] for all axes (cubic volumes in every config)."""
    n = cloud.shape[0]
    feats = np.concatenate(
        [np.ones((n, 1), np.float32), rgb.astype(np.float32), cloud.astype(np.float32)],
        axis=1,
    )
    vidx = ((cloud + total_extent[0] * 0.5) / unit_voxel_extent).astype(np.int64)
    vidx = np.clip(vidx, 0, np.asarray(voxel_num_limit, np.int64) - 1)
    return feats, vidx.astype(np.int32)


def normalize_rgb(img_crop: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float, /255, minus ImageNet mean (reference :142-144)."""
    return img_crop.astype(np.float32) / 255.0 - IMAGENET_MEAN
