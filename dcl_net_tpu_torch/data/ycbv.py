"""YCB-Video datasets (train + test) producing fixed-shape samples.

The port's own copy of dcl_net_tpu/data/ycbv.py on its numpy path, with the
same draws from the same generators, so a sample equals the JAX reader's
array for array:
- train (reference YCBV/dataloader_train_YCBV.py): random instance choice,
  bbox snap, depth lift with the two camera intrinsics sets, centroid
  centering, SE(3) augmentation, volume filter, resample to input_size
  points; draws from the global np.random and Python's random;
- test (reference YCBV/dataloader_test_YCBV.py): every ground-truth
  instance of each frame, with the FFB6D-predicted masks and rois of
  datasets/YCBV_Masks/Masks_FFB6D; an undetected instance is a lost
  detection (reference all_flags=0, :116-123); resampling draws from the
  global np.random.

Instances are padded to a fixed batch with valid flags (data/schema.py)
instead of ragged batches.

Raw-candidate mode (config key device_preprocess: True; device_cand_k,
default 8192): a sample is the mask's candidate pixels (data/preprocess.py::
gather_candidates) with the camera, the labels and the template branch, and
data/device_preprocess.py does the lift, centering, augmentation, filter,
resample and assembly on the device. The train reader then decodes a frame
once and draws samples_per_frame instances from it (a list of samples,
which BatchLoader(samples_per_item=...) flattens); samples_per_frame > 1
without device_preprocess raises, since the numpy path draws one instance
a frame.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from dcl_net_tpu_torch.data import png
from dcl_net_tpu_torch.data import preprocess as pp
from dcl_net_tpu_torch.data.ply import read_ply
from dcl_net_tpu_torch.data.png import imread
from dcl_net_tpu_torch.registry import DATASETS

# Camera intrinsics (reference YCBV/dataloader_train_YCBV.py:83-91)
CAM_1 = dict(cx=312.9869, cy=241.3109, fx=1066.778, fy=1067.487)
CAM_2 = dict(cx=323.7872, cy=279.6921, fx=1077.836, fy=1078.189)
TEST_CAM_SCALE = 10000.0
SYMMETRY_OBJ_IDX = [12, 15, 18, 19, 20]  # 0-based (reference :98)
NUM_CLASSES = 21


def _load_cads(cad_dir: str, classes_file: str, n_tmp: int, n_downsample: int = 1024):
    """Load the CAD clouds exactly like the reference init
    (YCBV/dataloader_train_YCBV.py:53-76): np.random.seed(1), choose n_tmp
    points without replacement, colors minus ImageNet mean, points in mm.
    The global np.random state is restored afterwards."""
    with open(classes_file) as f:
        class_names = [line.strip() for line in f if line.strip()]
    rng_state = np.random.get_state()
    np.random.seed(1)
    rgb_cad, pc_cad, pc_cad_ds, radius = {}, {}, {}, {}
    for class_id, name in enumerate(class_names, start=1):
        ply = read_ply(os.path.join(cad_dir, name + "_pc.ply"))
        pts, cols = ply["points"], ply.get("colors")
        if cols is None:  # colorless CAD: zero colors, like the LM loader
            cols = np.zeros_like(pts)
        n_avail = pts.shape[0]
        if n_avail < n_tmp:
            choose = np.random.choice(n_avail, n_tmp)
        else:
            choose = np.random.choice(n_avail, n_tmp, replace=False)
        rgb_cad[class_id] = cols[choose] - pp.IMAGENET_MEAN
        pc_cad[class_id] = pts[choose] * 1000.0
        choose_ds = np.random.choice(n_avail, n_downsample, replace=False)
        pc_cad_ds[class_id] = pts[choose_ds] * 1000.0
        radius[class_id] = float(np.linalg.norm(pts[choose], axis=1).max())
    np.random.set_state(rng_state)
    return class_names, rgb_cad, pc_cad, pc_cad_ds, radius


def roi_bbox(posecnn_rois: np.ndarray, idx: int):
    """FFB6D/PoseCNN roi -> snapped bbox
    (reference YCBV/dataloader_test_YCBV.py:266-303)."""
    rmin = max(int(posecnn_rois[idx][3]) + 1, 0)
    rmax = min(int(posecnn_rois[idx][5]) - 1, 480)
    cmin = max(int(posecnn_rois[idx][2]) + 1, 0)
    cmax = min(int(posecnn_rois[idx][4]) - 1, 640)
    r_b = rmax - rmin
    for tt in range(len(pp.BORDER_LIST) - 1):
        if pp.BORDER_LIST[tt] < r_b < pp.BORDER_LIST[tt + 1]:
            r_b = pp.BORDER_LIST[tt + 1]
            break
    c_b = cmax - cmin
    for tt in range(len(pp.BORDER_LIST) - 1):
        if pp.BORDER_LIST[tt] < c_b < pp.BORDER_LIST[tt + 1]:
            c_b = pp.BORDER_LIST[tt + 1]
            break
    center = [(rmin + rmax) // 2, (cmin + cmax) // 2]
    rmin, rmax = center[0] - r_b // 2, center[0] + r_b // 2
    cmin, cmax = center[1] - c_b // 2, center[1] + c_b // 2
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > 480:
        rmin -= rmax - 480
        rmax = 480
    if cmax > 640:
        cmin -= cmax - 640
        cmax = 640
    return rmin, rmax, cmin, cmax


class _YCBVBase:
    """What the train and test readers share: the config's sizes and volume,
    the file list and the CAD clouds (loaded once, from a seeded draw)."""

    def __init__(self, cfg, root: str, assets_dir: Optional[str],
                 list_file: Optional[str], default_list: str, train: bool):
        pp.read_raw_cfg(self, cfg, train)
        # the readers' workers load the PNG host library: built here, in the
        # parent, so process workers do not each compile it
        png.build()
        assets = assets_dir or os.path.join(root, "..")
        self.root = root
        self.assets = assets
        self.n_inp = int(cfg.input_size)
        self.n_tmp = int(cfg.tmp_size)
        self.unit = np.asarray(cfg.unit_voxel_extent, np.float32)
        self.limit = np.asarray(cfg.voxel_num_limit, np.float32)
        self.total = self.unit * self.limit
        with open(list_file or os.path.join(assets, default_list)) as f:
            self.list = [line.strip() for line in f if line.strip()]
        (self.class_names, self.rgb_cad, self.pc_cad, self.pc_cad_ds,
         self.radius) = _load_cads(os.path.join(assets, "CADs"),
                                   os.path.join(assets, "classes.txt"), self.n_tmp)
        self.min_pt = 50
        self.device_min_points = 50  # the device filter's min_keep (train)

    def __len__(self):
        return len(self.list)

    def _tmp_branch(self, obj_id: int):
        """Template inputs of class obj_id (1-based): its CAD draw in metres."""
        model_points = (self.pc_cad[obj_id] / 1000.0).astype(np.float32)
        return pp.assemble_features(
            model_points, self.rgb_cad[obj_id].astype(np.float32),
            self.unit, self.total, self.limit,
        )

    def _raw_sample(self, img, depth, obj_id: int, rows, cols, cam, cam_scale: float,
                    target_r, target_t) -> Dict:
        """A raw-candidate sample of class obj_id (1-based): the candidate
        pixels at (rows, cols), the camera [cx, cy, fx, fy, scale], the
        labels and the template branch."""
        feats_tmp, vidx_tmp = self._tmp_branch(obj_id)
        return {
            **pp.gather_candidates(img, depth, rows, cols, self.cand_k),
            "cam": np.asarray([cam["cx"], cam["cy"], cam["fx"], cam["fy"], cam_scale],
                              np.float32),
            "tmp_feats": feats_tmp, "tmp_voxel_idx": vidx_tmp,
            "rot_gt": target_r, "trans_gt": target_t,
            "obj_idx": np.int32(obj_id - 1),
            "sym_flag": np.float32(1.0 if (obj_id - 1) in SYMMETRY_OBJ_IDX else 0.0),
            "valid": 1.0,
        }

    def template_bank(self) -> Dict[str, np.ndarray]:
        """Per-class template inputs {feats [C,M,7], voxel_idx [C,M,3]}:
        the CAD clouds sampled once at init (reference :59-76), so the
        evaluator (and banked-template training) encodes each class once."""
        feats, vidx = zip(*(self._tmp_branch(c) for c in sorted(self.pc_cad)))
        return {"feats": np.stack(feats), "voxel_idx": np.stack(vidx)}


@DATASETS.register("ycbv_train")
class YCBVTrainDataset(_YCBVBase):
    def __init__(self, cfg, root: str, list_file: Optional[str] = None,
                 assets_dir: Optional[str] = None):
        super().__init__(cfg, root, assets_dir, list_file, "train_data_list.txt", train=True)

    def _intrinsics(self, path: str) -> Dict[str, float]:
        # videos >= 60 use the second camera (reference :113-122)
        if path[:8] != "data_syn" and int(path[5:9]) >= 60:
            return CAM_2
        return CAM_1

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        import scipy.io as scio

        rng = np.random  # module-level RNG like the reference workers
        path = self.list[index]
        img = imread(f"{self.root}/{path}-color.png")[:, :, :3]
        depth = imread(f"{self.root}/{path}-depth.png")
        label = imread(f"{self.root}/{path}-label.png")
        meta = scio.loadmat(f"{self.root}/{path}-meta.mat")
        objs = meta["cls_indexes"].flatten().astype(np.int32)
        cam = self._intrinsics(path)

        mask_depth = depth != 0

        if self.raw_mode:
            # decode once, draw samples_per_frame instances from the frame
            out = [self._draw_raw(img, depth, label, objs, meta, cam, mask_depth, rng)
                   for _ in range(self.samples_per_frame)]
            return out if self.samples_per_frame > 1 else out[0]

        # random instance with enough pixels (reference :126-132)
        for _ in range(100):
            idx = rng.randint(0, len(objs))
            mask_label = label == objs[idx]
            mask = mask_label & mask_depth
            if mask.sum() > self.min_pt:
                break
        else:
            return self._invalid()

        rmin, rmax, cmin, cmax = pp.get_bbox(mask_label)
        target_r = meta["poses"][:, :, idx][:, 0:3].astype(np.float32)
        target_t = meta["poses"][:, :, idx][:, 3].astype(np.float32)

        choose = mask[rmin:rmax, cmin:cmax].flatten().nonzero()[0]
        if len(choose) < self.min_pt:
            return self._invalid()

        rgb = pp.normalize_rgb(img[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose])
        cam_scale = float(meta["factor_depth"][0][0])
        cloud = pp.depth_to_cloud(
            depth, choose, rmin, rmax, cmin, cmax,
            cam["cx"], cam["cy"], cam["fx"], cam["fy"], cam_scale,
        )
        centroid = cloud.mean(axis=0)
        cloud = (cloud - centroid).astype(np.float32)
        target_t = target_t - centroid.astype(np.float32)

        # the draw sequence (instance randint, 3 angle uniforms, 3 Python
        # random translation uniforms, resample choice) matches the
        # reference loader call for call
        cloud, target_r, target_t = pp.se3_augment(
            cloud, target_r, target_t, rng, trans_rng=random
        )

        res = pp.filter_and_resample(cloud, rgb, self.total, self.n_inp, rng,
                                     self.min_pt)
        if res is None:
            return self._invalid()
        cloud, rgb = res
        feats_inp, vidx_inp = pp.assemble_features(cloud, rgb, self.unit, self.total,
                                                   self.limit)

        obj_id = int(objs[idx])
        feats_tmp, vidx_tmp = self._tmp_branch(obj_id)
        return {
            "inp_feats": feats_inp, "inp_voxel_idx": vidx_inp,
            "tmp_feats": feats_tmp, "tmp_voxel_idx": vidx_tmp,
            "rot_gt": target_r, "trans_gt": target_t,
            "obj_idx": np.int32(obj_id - 1),
            "sym_flag": np.float32(1.0 if (obj_id - 1) in SYMMETRY_OBJ_IDX else 0.0),
            "valid": 1.0,
            "radius": np.float32(self.radius[obj_id]),
        }

    def _invalid(self):
        n, m = self.n_inp, self.n_tmp
        return {
            "inp_feats": np.zeros((n, 7), np.float32),
            "inp_voxel_idx": np.zeros((n, 3), np.int32),
            "tmp_feats": np.zeros((m, 7), np.float32),
            "tmp_voxel_idx": np.zeros((m, 3), np.int32),
            "rot_gt": np.zeros((3, 3), np.float32),
            "trans_gt": np.zeros(3, np.float32),
            "obj_idx": np.int32(-1), "sym_flag": np.float32(-1.0),
            "valid": 0.0, "radius": np.float32(-1.0),
        }

    def _draw_raw(self, img, depth, label, objs, meta, cam, mask_depth, rng):
        """One instance draw as a raw-candidate sample: the numpy path's
        instance choice (reference :126-132) and bbox snap, then the
        candidate pixels of the mask in the box."""
        for _ in range(100):
            idx = rng.randint(0, len(objs))
            mask_label = label == objs[idx]
            mask = mask_label & mask_depth
            if mask.sum() > self.min_pt:
                break
        else:
            return self._invalid_raw()
        rmin, rmax, cmin, cmax = pp.get_bbox(mask_label)
        target_r = meta["poses"][:, :, idx][:, 0:3].astype(np.float32)
        target_t = meta["poses"][:, :, idx][:, 3].astype(np.float32)
        r_loc, c_loc = np.nonzero(mask[rmin:rmax, cmin:cmax])
        if len(r_loc) < self.min_pt:
            return self._invalid_raw()
        obj_id = int(objs[idx])
        sample = self._raw_sample(img, depth, obj_id, rmin + r_loc, cmin + c_loc, cam,
                                  float(meta["factor_depth"][0][0]), target_r, target_t)
        sample["radius"] = np.float32(self.radius[obj_id])
        return sample

    def _invalid_raw(self):
        return {
            **pp.invalid_candidates(self.cand_k, self.n_tmp),
            "rot_gt": np.zeros((3, 3), np.float32),
            "trans_gt": np.zeros(3, np.float32),
            "obj_idx": np.int32(-1), "sym_flag": np.float32(-1.0),
            "valid": 0.0, "radius": np.float32(-1.0),
        }


@DATASETS.register("ycbv_test")
class YCBVTestDataset(_YCBVBase):
    """Per-frame eval dataset with FFB6D masks (reference
    YCBV/dataloader_test_YCBV.py). __getitem__ yields the frame's instance
    samples and lost-detection records; `frames()` iterates one padded
    batch per frame."""

    def __init__(self, cfg, root: str, masks_dir: Optional[str] = None,
                 list_file: Optional[str] = None, assets_dir: Optional[str] = None):
        super().__init__(cfg, root, assets_dir, list_file, "test_data_list.txt", train=False)
        self.masks_dir = masks_dir or os.path.join(self.assets, "YCBV_Masks",
                                                   "Masks_FFB6D")

    def model_points_array(self, models_dir: Optional[str] = None,
                           n_points: int = 2620) -> np.ndarray:
        """[num_classes, P, 3] CAD clouds in metres for metric computation.

        The reference eval scores against the first 2620 rows of each class's
        ``models/<name>/points.xyz`` (reference tools/test_YCBV_stage1.py:
        147-169); when that directory exists it is read, otherwise the
        sampled template clouds are used."""
        if models_dir and os.path.isdir(models_dir):
            clouds = []
            for name in self.class_names:
                path = os.path.join(models_dir, name, "points.xyz")
                clouds.append(np.loadtxt(path, dtype=np.float32)[:n_points, :3])
            return np.stack(clouds).astype(np.float32)
        return np.stack(
            [self.pc_cad[c] / 1000.0 for c in sorted(self.pc_cad)]
        ).astype(np.float32)

    def __getitem__(self, index: int):
        import scipy.io as scio

        rng = np.random
        path = self.list[index]
        img = imread(f"{self.root}/{path}-color.png")[:, :, :3]
        depth = imread(f"{self.root}/{path}-depth.png")
        mask_depth = depth != 0
        posecnn_meta = scio.loadmat(f"{self.masks_dir}/{index:06d}.mat")
        label = np.array(posecnn_meta["labels"])
        rois = np.array(posecnn_meta["rois"])
        gt_meta = scio.loadmat(f"{self.root}/{path}-meta.mat")
        gt_obj = gt_meta["cls_indexes"].flatten().astype(np.int32)

        samples: List[Dict] = []
        lost: List[Dict] = []
        for idx in range(gt_obj.shape[0]):
            obj_id = int(gt_obj[idx])
            target_r = gt_meta["poses"][:, :, idx][:, 0:3].astype(np.float32)
            target_t = gt_meta["poses"][:, :, idx][:, 3].astype(np.float32)

            detected = np.sum(rois[:, 1] == obj_id) > 0
            choose = None
            if detected:
                roi_i = np.where(rois[:, 1] == obj_id)[0][0]
                rmin, rmax, cmin, cmax = roi_bbox(rois, roi_i)
                mask = (label == obj_id) & mask_depth
                choose = mask[rmin:rmax, cmin:cmax].flatten().nonzero()[0]
            if not detected or choose is None or choose.shape[0] == 0:
                lost.append({"obj_idx": obj_id - 1, "rot_gt": target_r,
                             "trans_gt": target_t, "gt_pos": idx})
                continue

            if self.raw_mode:
                # the device filter applies the keep-clamp (eval_keep_clamp)
                w = cmax - cmin
                sample = self._raw_sample(img, depth, obj_id, rmin + choose // w,
                                          cmin + choose % w, CAM_1, TEST_CAM_SCALE,
                                          target_r, target_t)
                sample["gt_pos"] = idx
                samples.append(sample)
                continue

            rgb = pp.normalize_rgb(img[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose])
            cloud = pp.depth_to_cloud(
                depth, choose, rmin, rmax, cmin, cmax,
                CAM_1["cx"], CAM_1["cy"], CAM_1["fx"], CAM_1["fy"],
                TEST_CAM_SCALE,
            )
            centroid = cloud.mean(axis=0)
            cloud = (cloud - centroid).astype(np.float32)
            target_t = target_t - centroid.astype(np.float32)

            # eval keeps out-of-volume points when too few remain
            # (reference :164-180: filter only if >32 survive, else clamp)
            keep = (
                (np.abs(cloud[:, 0]) < self.total[0] * 0.5)
                & (np.abs(cloud[:, 1]) < self.total[1] * 0.5)
                & (np.abs(cloud[:, 2]) < self.total[2] * 0.5)
            )
            if keep.sum() > 32:
                cloud, rgb = cloud[keep], rgb[keep]
            if cloud.shape[0] > self.n_inp:
                sel = rng.choice(cloud.shape[0], self.n_inp, replace=False)
            else:
                sel = rng.choice(cloud.shape[0], self.n_inp)
            cloud, rgb = cloud[sel], rgb[sel]
            feats_inp, vidx_inp = pp.assemble_features(cloud, rgb, self.unit, self.total,
                                                       self.limit)
            feats_tmp, vidx_tmp = self._tmp_branch(obj_id)
            samples.append({
                "inp_feats": feats_inp, "inp_voxel_idx": vidx_inp,
                "tmp_feats": feats_tmp, "tmp_voxel_idx": vidx_tmp,
                "rot_gt": target_r, "trans_gt": target_t,
                "obj_idx": np.int32(obj_id - 1),
                "sym_flag": np.float32(1.0 if (obj_id - 1) in SYMMETRY_OBJ_IDX else 0.0),
                "valid": 1.0, "centroid": centroid.astype(np.float32),
                "gt_pos": idx,
            })
        return {"samples": samples, "lost": lost, "path": path}

    def invalid_row(self) -> Dict:
        """A valid=0 placeholder row (lost detection / padding); its input
        features are replaced by a real sample's in make_batch (or
        make_raw_batch in raw mode)."""
        if self.raw_mode:
            return {**pp.invalid_candidates(self.cand_k, self.n_tmp),
                    "rot_gt": np.zeros((3, 3), np.float32),
                    "trans_gt": np.zeros(3, np.float32),
                    "obj_idx": np.int32(0), "sym_flag": np.float32(0.0), "valid": 0.0}
        n, m = self.n_inp, self.n_tmp
        return {
            "inp_feats": np.zeros((n, 7), np.float32),
            "inp_voxel_idx": np.zeros((n, 3), np.int32),
            "tmp_feats": np.zeros((m, 7), np.float32),
            "tmp_voxel_idx": np.zeros((m, 3), np.int32),
            "rot_gt": np.zeros((3, 3), np.float32),
            "trans_gt": np.zeros(3, np.float32),
            "obj_idx": np.int32(0),
            "sym_flag": np.float32(0.0),
            "valid": 0.0,
        }

    def frames(self, pad_to: Optional[int] = None):
        """Reference-protocol iteration: ONE batch per image holding exactly
        that image's ground-truth instances in gt order, with lost
        detections as valid=0 rows carrying their true labels (reference
        YCBV/dataloader_test_YCBV.py:116-144 marks all_flags=0 in place and
        :259-260 batches all instances of one image together). Yields
        (batch_dict, path). Raw mode raises: this iteration needs the numpy
        path (the device path serves EvalFrameLoader)."""
        from dcl_net_tpu_torch.data.schema import make_batch

        if self.raw_mode:
            raise ValueError("frames() needs the numpy path: construct the dataset "
                             "without device_preprocess (the device path serves "
                             "EvalFrameLoader)")
        for i in range(len(self)):
            frame = self[i]
            rows = list(frame["samples"])
            for lost in frame["lost"]:
                row = self.invalid_row()
                row.update(
                    rot_gt=lost["rot_gt"], trans_gt=lost["trans_gt"],
                    obj_idx=np.int32(lost["obj_idx"]), valid=0.0,
                    gt_pos=lost["gt_pos"],
                )
                rows.append(row)
            rows.sort(key=lambda r: r["gt_pos"])
            yield make_batch(rows, pad_to=pad_to).to_dict(), frame["path"]
