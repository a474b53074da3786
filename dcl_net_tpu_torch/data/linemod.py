"""LineMOD and Occlusion-LineMOD datasets producing fixed-shape samples.

The port's own copy of dcl_net_tpu/data/linemod.py on its numpy path, with
the same draws from the same generators, so a sample equals the JAX
reader's array for array:
- LM train / test / eval (reference LM/dataloader_train_LM.py,
  LM/dataloader_test_LM.py): 13 objects, CAD clouds sampled uniformly from
  the mesh surface, gt.yml poses, the occlusion augmentation of train mode
  (pasting another object's crop, :293-348), SegNet masks in eval mode
  (:80); draws from the global np.random and Python's random;
- LMO eval (reference LM/dataloader_test_LMO.py): 8 objects, HybridPose
  masks, valid_poses txt files, the alignment flip and the per-object
  LineMOD -> Occlusion rotation (:44-101). The reference composes only the
  rotation of that transform (R = R @ R_lo; t_lo unused, :135-138), and so
  does this copy.

An empty mask is a lost detection: a valid = 0 row (LMO keeps its class).
The raw-candidate mode of device-side preprocessing (device_preprocess,
samples_per_frame > 1) is not ported and raises.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from dcl_net_tpu_torch.data import preprocess as pp
from dcl_net_tpu_torch.data.ply import read_ply, sample_points_uniformly
from dcl_net_tpu_torch.data.png import imread

CAM = dict(cx=325.26110, cy=242.04899, fx=572.41140, fy=573.57043)
LM_OBJLIST = [1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]
LM_SYM_IDX = [7, 8]        # eggbox, glue (indices in LM_OBJLIST)
LMO_OBJLIST = [1, 5, 6, 8, 9, 10, 11, 12]
LMO_SYM_IDX = [5, 6]       # eggbox, glue (indices in LMO_OBJLIST)
LMO_ID2NAME = {1: "ape", 5: "can", 6: "cat", 8: "driller", 9: "duck",
               10: "eggbox", 11: "glue", 12: "holepuncher"}

ALIGNMENT_FLIPPING = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32
)

_LMO_TRANSFORMS = {
    # (reference LM/dataloader_test_LMO.py:44-87)
    "ape": ([[0, -1, 0], [0, 0, 1], [-1, 0, 0]],
            [0.00464956, -0.04454319, -0.00454451]),
    "can": ([[0, -1, 0], [0, 0, 1], [-1, 0, 0]],
            [-0.009928, -0.08974387, -0.00697199]),
    "cat": ([[0, 1, 0], [0, 0, 1], [1, 0, 0]],
            [-0.01460595, -0.05390565, 0.00600646]),
    "driller": ([[0, -1, 0], [0, 0, 1], [-1, 0, 0]],
                [-0.00176942, -0.10016585, 0.00840302]),
    "duck": ([[0, 1, 0], [0, 0, 1], [1, 0, 0]],
             [-0.00285449, -0.04044429, 0.00110274]),
    "eggbox": ([[0, 1, 0], [0, 0, 1], [1, 0, 0]], [-0.01, -0.03, -0.00]),
    "glue": ([[0, -1, 0], [0, 0, 1], [-1, 0, 0]],
             [-0.00144855, -0.07744411, -0.00468425]),
    "holepuncher": ([[0, 1, 0], [0, 0, 1], [1, 0, 0]],
                    [-0.00425799, -0.03734197, 0.00175619]),
}


def linemod_to_occlusion_transformation(name: str):
    r, t = _LMO_TRANSFORMS[name]
    return np.asarray(r, np.float32), np.asarray(t, np.float32).reshape(3, 1)


def lm_bbox_snap(bbox) -> tuple:
    """gt.yml obj_bb [x,y,w,h] -> snapped (rmin,rmax,cmin,cmax)
    (reference LM/dataloader_train_LM.py:353-395)."""
    bbx = [bbox[1], bbox[1] + bbox[3], bbox[0], bbox[0] + bbox[2]]
    bbx[0] = max(bbx[0], 0)
    bbx[1] = min(bbx[1], 479)
    bbx[2] = max(bbx[2], 0)
    bbx[3] = min(bbx[3], 639)
    rmin, rmax, cmin, cmax = bbx
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
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
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


def _load_lm_cads(models_dir: str, objlist: List[int], n_tmp: int, seed: int = 0):
    """CAD clouds sampled uniformly from each mesh's surface (reference
    LM/dataloader_train_LM.py:64-67, open3d's sample_points_uniformly), from
    a RandomState of its own; points in mm, colors minus the ImageNet mean."""
    rgb_cad, pc_cad, radius = {}, {}, {}
    rng = np.random.RandomState(seed)
    for item in objlist:
        ply = read_ply(os.path.join(models_dir, "obj_%02d.ply" % item))
        pts, cols = sample_points_uniformly(
            ply["points"], ply["faces"], n_tmp, rng, ply.get("colors"))
        if cols is None:
            cols = np.zeros_like(pts)
        rgb_cad[item] = cols - pp.IMAGENET_MEAN
        pc_cad[item] = pts  # LM PLYs are in mm
        radius[item] = float(np.linalg.norm(pts / 1000.0, axis=1).max())
    return rgb_cad, pc_cad, radius


def _refuse_raw_mode(cfg) -> None:
    if bool(cfg.get("device_preprocess", False)):
        raise NotImplementedError(
            "device_preprocess: the raw-candidate mode of device-side "
            "preprocessing (queue A 6) is not ported yet")
    if int(cfg.get("samples_per_frame", 1)) > 1:
        raise NotImplementedError("samples_per_frame > 1: not ported yet (queue A 6)")


class _LMBase:
    """What the LineMOD readers share: the config's sizes and volume, the
    volume filter and resample, the lift, the template inputs."""

    def _read_cfg(self, cfg) -> None:
        _refuse_raw_mode(cfg)
        self.n_inp = int(cfg.input_size)
        self.n_tmp = int(cfg.tmp_size)
        self.unit = np.asarray(cfg.unit_voxel_extent, np.float32)
        self.limit = np.asarray(cfg.voxel_num_limit, np.float32)
        self.total = self.unit * self.limit

    def _finalize(self, cloud, rgb, obj, sym_flag, target_r, target_t,
                  centroid, obj_index, min_keep, rng, keep_all_if_few=False):
        keep = (
            (np.abs(cloud[:, 0]) < self.total[0] * 0.5)
            & (np.abs(cloud[:, 1]) < self.total[1] * 0.5)
            & (np.abs(cloud[:, 2]) < self.total[2] * 0.5)
        )
        # reference LM/dataloader_test_LM.py:195-204: keep the in-volume
        # points when more than min_keep survive, and in eval mode
        # (keep_all_if_few) whenever any survive; with none surviving the
        # reference would crash in np.random.choice, and the full cloud is
        # kept instead
        if keep.sum() > min_keep or keep_all_if_few:
            if keep.sum() > 0:
                cloud, rgb = cloud[keep], rgb[keep]
        else:
            return self._invalid()
        if cloud.shape[0] > self.n_inp:
            sel = rng.choice(cloud.shape[0], self.n_inp, replace=False)
        else:
            sel = rng.choice(cloud.shape[0], self.n_inp)
        cloud, rgb = cloud[sel], rgb[sel]
        feats_inp, vidx_inp = pp.assemble_features(cloud, rgb, self.unit, self.total,
                                                   self.limit)
        feats_tmp, vidx_tmp = self._tmp_branch(obj)
        return {
            "inp_feats": feats_inp, "inp_voxel_idx": vidx_inp,
            "tmp_feats": feats_tmp, "tmp_voxel_idx": vidx_tmp,
            "rot_gt": target_r.astype(np.float32),
            "trans_gt": target_t.astype(np.float32),
            "obj_idx": np.int32(obj_index),
            "sym_flag": np.float32(sym_flag),
            "valid": 1.0,
            "centroid": centroid.astype(np.float32),
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
            "obj_idx": np.int32(0), "sym_flag": np.float32(-1.0),
            "valid": 0.0, "centroid": np.zeros(3, np.float32),
        }

    def _lift(self, depth, choose, rmin, rmax, cmin, cmax):
        cloud = pp.depth_to_cloud(
            depth, choose, rmin, rmax, cmin, cmax,
            CAM["cx"], CAM["cy"], CAM["fx"], CAM["fy"], 1.0,
        )
        return cloud / 1000.0  # LM depths are mm with cam_scale 1

    def _tmp_branch(self, obj: int):
        """Template inputs of object `obj`: its CAD draw in metres."""
        pts = (self.pc_cad[obj] / 1000.0).astype(np.float32)
        return pp.assemble_features(
            pts, self.rgb_cad[obj].astype(np.float32), self.unit, self.total, self.limit)

    def model_points_array(self) -> np.ndarray:
        """[num_objects, n_tmp, 3] CAD clouds in metres for the metric
        (reference tools/test_LM.py: pc_cad / 1000)."""
        return np.stack([self.pc_cad[o] / 1000.0 for o in self.objlist]).astype(np.float32)

    def template_bank(self) -> Dict[str, np.ndarray]:
        """Per-class template inputs {feats [C,M,7], voxel_idx [C,M,3]} for
        the evaluator's template cache and banked-template training."""
        feats, vidx = zip(*(self._tmp_branch(obj) for obj in self.objlist))
        return {"feats": np.stack(feats), "voxel_idx": np.stack(vidx)}


class LineMODDataset(_LMBase):
    """13-object LineMOD (train / test / eval with SegNet masks)."""

    def __init__(self, mode: str, cfg, root: str):
        import yaml

        self.mode = mode
        self.root = root
        self._read_cfg(cfg)
        self.objlist = list(LM_OBJLIST)

        self.list_rgb: List[str] = []
        self.list_depth: List[str] = []
        self.list_label: List[str] = []
        self.list_obj: List[int] = []
        self.list_rank: List[int] = []
        self.meta: Dict[int, dict] = {}
        self.index_ranges: Dict[int, List[int]] = {}

        for item in self.objlist:
            start = len(self.list_rgb)
            split = "train" if mode == "train" else "test"
            with open(f"{root}/data/{item:02d}/{split}.txt") as f:
                # test mode keeps every object's own 10th, 20th, ... line:
                # the reference's shared readline counter (:69-77) runs on to
                # the next multiple of 10 at each file's end
                item_count = 0
                for line in f:
                    item_count += 1
                    if mode == "test" and item_count % 10 != 0:
                        continue
                    line = line.strip()
                    if not line:
                        continue
                    self.list_rgb.append(f"{root}/data/{item:02d}/rgb/{line}.png")
                    self.list_depth.append(f"{root}/data/{item:02d}/depth/{line}.png")
                    if mode == "eval":
                        self.list_label.append(
                            f"{root}/segnet_results/{item:02d}_label/{line}_label.png")
                    else:
                        self.list_label.append(f"{root}/data/{item:02d}/mask/{line}.png")
                    self.list_obj.append(item)
                    self.list_rank.append(int(line))
            self.index_ranges[item] = [start, len(self.list_rgb)]
            with open(f"{root}/data/{item:02d}/gt.yml") as f:
                self.meta[item] = yaml.safe_load(f)

        self.rgb_cad, self.pc_cad, self.radius = _load_lm_cads(
            os.path.join(root, "models"), self.objlist, self.n_tmp)
        self.length = len(self.list_rgb)

    def __len__(self):
        return self.length

    def diameters(self, models_info_path: Optional[str] = None) -> List[float]:
        """0.1 x diameter per object in metres (reference tools/test_LM.py:
        68-76)."""
        import yaml

        path = models_info_path or os.path.join(self.root, "models", "models_info.yml")
        with open(path) as f:
            meta = yaml.safe_load(f)
        return [meta[obj]["diameter"] / 1000.0 * 0.1 for obj in self.objlist]

    # -- occlusion augmentation (reference LM/dataloader_train_LM.py:286-348)
    def _get_other_idx(self, obj_idx: int) -> int:
        start, stop = self.index_ranges[obj_idx]
        length_all = self.index_ranges[15][1]
        return random.choice(list(range(start)) + list(range(stop, length_all)))

    def occlude_with_another_object(self, image, depth, mask, obj_id):
        orig = (image.copy(), depth.copy(), mask.copy())
        try:
            other_idx = self._get_other_idx(obj_id)
            o_img = imread(self.list_rgb[other_idx])
            o_dep = imread(self.list_depth[other_idx])
            o_msk = imread(self.list_label[other_idx])
            oys, oxs = np.nonzero(o_msk[:, :, 0])
            oy0, oy1 = oys.min(), oys.max()
            ox0, ox1 = oxs.min(), oxs.max()
            ys, xs = np.nonzero(mask[:, :, 0])
            y0, y1 = ys.min(), ys.max()
            x0, x1 = xs.min(), xs.max()
            o_msk = o_msk[oy0:oy1 + 1, ox0:ox1 + 1]
            o_img = o_img[oy0:oy1 + 1, ox0:ox1 + 1]
            o_dep = o_dep[oy0:oy1 + 1, ox0:ox1 + 1]
            sy = np.random.randint(y0 - o_msk.shape[0] + 1, y1 + 1)
            ey = sy + o_msk.shape[0]
            sx = np.random.randint(x0 - o_msk.shape[1] + 1, x1 + 1)
            ex = sx + o_msk.shape[1]
            if sy < 0:
                o_msk, o_img, o_dep = o_msk[-sy:], o_img[-sy:], o_dep[-sy:]
                sy = 0
            if ey > image.shape[0]:
                ey = image.shape[0]
                o_msk, o_img, o_dep = o_msk[:ey - sy], o_img[:ey - sy], o_dep[:ey - sy]
            if sx < 0:
                o_msk, o_img, o_dep = o_msk[:, -sx:], o_img[:, -sx:], o_dep[:, -sx:]
                sx = 0
            if ex > image.shape[1]:
                ex = image.shape[1]
                o_msk, o_img, o_dep = o_msk[:, :ex - sx], o_img[:, :ex - sx], o_dep[:, :ex - sx]
            outline = (o_msk == 0)
            image[sy:ey, sx:ex] = image[sy:ey, sx:ex] * outline
            depth[sy:ey, sx:ex] = depth[sy:ey, sx:ex] * outline[:, :, 0]
            o_img = o_img * (o_msk != 0)
            o_dep = o_dep * (o_msk != 0)[:, :, 0]
            image[sy:ey, sx:ex] += o_img
            depth[sy:ey, sx:ex] += o_dep
            mask[sy:ey, sx:ex] = mask[sy:ey, sx:ex] * outline
            if mask.sum() >= 20:
                return image, depth, mask
            return orig
        except Exception:
            return orig

    def _meta_of(self, obj: int, rank: int) -> dict:
        # gt.yml stores several entries for scene 2 (reference :136-141)
        if obj == 2:
            return next(m for m in self.meta[obj][rank] if m["obj_id"] == 2)
        return self.meta[obj][rank][0]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random
        img = imread(self.list_rgb[index])[:, :, :3]
        depth = imread(self.list_depth[index])
        label = imread(self.list_label[index])
        obj = self.list_obj[index]
        rank = self.list_rank[index]

        if self.mode == "train":
            img, depth, label = self.occlude_with_another_object(img, depth, label, obj)

        meta = self._meta_of(obj, rank)

        mask_depth = depth != 0
        if self.mode == "eval":
            mask_label = label == 255
        else:
            mask_label = (label == np.array([255, 255, 255]))[:, :, 0]
        mask = mask_label & mask_depth

        if self.mode == "eval":
            # SegNet masks -> contour bbox (reference LM/dataloader_test_LM.py:143-146)
            rmin, rmax, cmin, cmax = lm_bbox_snap(pp.mask_to_bbox(mask_label))
        else:
            rmin, rmax, cmin, cmax = lm_bbox_snap(meta["obj_bb"])

        target_r = np.resize(np.array(meta["cam_R_m2c"]), (3, 3)).astype(np.float32)
        target_t = (np.array(meta["cam_t_m2c"]) / 1000.0).astype(np.float32)

        choose = mask[rmin:rmax, cmin:cmax].flatten().nonzero()[0]
        if len(choose) == 0:
            return self._invalid()
        rgb = pp.normalize_rgb(img[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose])
        cloud = self._lift(depth, choose, rmin, rmax, cmin, cmax).astype(np.float32)
        centroid = cloud.mean(axis=0)
        cloud = cloud - centroid
        target_t = target_t - centroid.astype(np.float32)

        if self.mode == "train":
            cloud, target_r, target_t = pp.se3_augment(
                cloud, target_r, target_t, rng, trans_rng=random)

        # the global generators straight through: the reference loader's
        # draw sequence (aug, then the resample's np.random.choice)
        sym = 1.0 if self.objlist.index(obj) in LM_SYM_IDX else 0.0
        return self._finalize(
            cloud, rgb, obj, sym, target_r, target_t, centroid,
            self.objlist.index(obj), min_keep=128,
            rng=rng, keep_all_if_few=(self.mode == "eval"),
        )


class OcclusionLineMODDataset(_LMBase):
    """Occlusion-LineMOD eval set with HybridPose masks."""

    def __init__(self, mode: str, cfg, root: str, lm_models_dir: str,
                 masks_dir: Optional[str] = None):
        self.mode = mode
        self.root = root
        self.masks_dir = masks_dir or os.path.join(os.path.dirname(root), "LMO_Masks")
        self._read_cfg(cfg)
        self.objlist = list(LMO_OBJLIST)

        self.rgb_cad, self.pc_cad, self.radius = _load_lm_cads(
            lm_models_dir, self.objlist, self.n_tmp)

        self.list_rgb, self.list_depth, self.list_label = [], [], []
        self.list_rot, self.list_trans, self.list_obj = [], [], []
        for item in self.objlist:
            name = LMO_ID2NAME[item]
            pose_dir = os.path.join(root, "valid_poses", name)
            for pose_file in sorted(os.listdir(pose_dir)):
                local_idx = int(pose_file.split(".")[0])
                r, t, img_id = self._read_pose(os.path.join(pose_dir, pose_file))
                r_lo, _t_lo = linemod_to_occlusion_transformation(name)
                r = (ALIGNMENT_FLIPPING @ r).astype(np.float32)
                t = (ALIGNMENT_FLIPPING @ t).astype(np.float32)
                r = r @ r_lo  # the reference composes the rotation only (:135-138)
                self.list_rgb.append(f"{root}/RGB-D/rgb_noseg/color_{img_id:05d}.png")
                self.list_depth.append(f"{root}/RGB-D/depth_noseg/depth_{img_id:05d}.png")
                self.list_label.append(f"{self.masks_dir}/{name}/{local_idx}.png")
                self.list_rot.append(r)
                self.list_trans.append(t.reshape(3))
                self.list_obj.append(item)
        self.length = len(self.list_rgb)

    @staticmethod
    def _read_pose(filename: str):
        """Parse a valid_poses txt file (reference LM/dataloader_test_LMO.py:
        172-193): (rotation [3,3], center [3,1], image id)."""
        read_rot = read_trans = False
        r_rows, t_row, last = [], [], ""
        with open(filename) as f:
            for line in f:
                if read_rot:
                    r_rows.append(line.split())
                    if len(r_rows) == 3:
                        read_rot = False
                elif read_trans:
                    t_row = line.split()
                    read_trans = False
                if line.startswith("rotation"):
                    read_rot = True
                elif line.startswith("center"):
                    read_trans = True
                last = line
        r = np.array(r_rows, np.float32)
        t = np.array(t_row, np.float32).reshape(3, 1)
        return r, t, int(last)

    def __len__(self):
        return self.length

    def diameters(self, models_info_path: str) -> List[float]:
        """0.1 x diameter per object in metres, from LineMOD's models_info.yml."""
        import yaml

        with open(models_info_path) as f:
            meta = yaml.safe_load(f)
        return [meta[obj]["diameter"] / 1000.0 * 0.1 for obj in self.objlist]

    def _lost(self, obj: int) -> Dict[str, np.ndarray]:
        out = self._invalid()
        out["obj_idx"] = np.int32(self.objlist.index(obj))
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random
        img = imread(self.list_rgb[index])[:, :, :3]
        depth = imread(self.list_depth[index])
        label = imread(self.list_label[index])
        obj = self.list_obj[index]
        target_r = np.resize(self.list_rot[index], (3, 3))
        target_t = np.array(self.list_trans[index])

        mask_depth = depth != 0
        if self.mode == "eval":
            mask_label = label == 1
        else:
            mask_label = (label == np.array([1, 1, 1]))[:, :, 0]
        mask = mask_label & mask_depth

        if not mask_label.any():
            return self._lost(obj)
        rmin, rmax, cmin, cmax = lm_bbox_snap(pp.mask_to_bbox(mask_label))
        choose = mask[rmin:rmax, cmin:cmax].flatten().nonzero()[0]
        if len(choose) == 0:
            return self._lost(obj)

        rgb = pp.normalize_rgb(img[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose])
        cloud = self._lift(depth, choose, rmin, rmax, cmin, cmax).astype(np.float32)
        centroid = cloud.mean(axis=0)
        cloud = cloud - centroid
        target_t = (target_t - centroid).astype(np.float32)

        sym = 1.0 if self.objlist.index(obj) in LMO_SYM_IDX else 0.0
        # the global generator, the reference eval loader's call sequence
        # (LM/dataloader_test_LMO.py:267-269)
        return self._finalize(
            cloud, rgb, obj, sym, target_r, target_t, centroid,
            self.objlist.index(obj), min_keep=0, rng=rng,
        )
