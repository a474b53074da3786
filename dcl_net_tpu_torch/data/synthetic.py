"""Synthetic pose dataset: procedurally generated CAD-like objects.

The port's own copy of dcl_net_tpu/data/synthetic.py (same draws from the
same seeds): a template cloud on a superquadric surface or on an on-disk
CAD cloud (cad_dir), an observed cloud = the visible part under a random
rigid transform with depth-like noise, and sym flags. Its frame mode is
the in-memory stand-in of the raw-mode readers' samples_per_frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from dcl_net_tpu_torch.registry import DATASETS


def _sample_superquadric(rng: np.random.RandomState, n: int):
    """Random superquadric-ish closed surface with per-point colors."""
    e1, e2 = rng.uniform(0.4, 1.6, 2)
    scale = rng.uniform(0.02, 0.06, 3)  # metres (YCB object scale)
    theta = rng.uniform(-np.pi / 2, np.pi / 2, n)
    phi = rng.uniform(-np.pi, np.pi, n)

    def f(w, m):
        return np.sign(np.sin(w)) * np.abs(np.sin(w)) ** m

    def g(w, m):
        return np.sign(np.cos(w)) * np.abs(np.cos(w)) ** m

    x = scale[0] * g(theta, e1) * g(phi, e2)
    y = scale[1] * g(theta, e1) * f(phi, e2)
    z = scale[2] * f(theta, e1)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    colors = (0.5 + 0.5 * np.tanh(pts / scale * 2.0)).astype(np.float32)
    return pts, colors


@DATASETS.register("synthetic")
class SyntheticPoseDataset:
    """Fixed-shape samples matching the real loaders' contract: features
    [1, rgb - imagenet_mean, xyz] and voxel indices from the metric volume."""

    def __init__(
        self,
        n_objects: int = 16,
        n_points: int = 1024,
        unit_voxel_extent: Sequence[float] = (0.006, 0.006, 0.006),
        voxel_num_limit: Sequence[int] = (64, 64, 64),
        sym_ratio: float = 0.25,
        length: int = 10000,
        seed: int = 0,
        noise: float = 0.002,
        cad_dir: Optional[str] = None,
        frame_mode: bool = False,
        samples_per_frame: int = 1,
    ):
        """cad_dir: read the objects from its *_pc.ply clouds (xyz + rgb,
        e.g. the 21 YCB-V object clouds) instead of drawing superquadrics;
        n_objects then keeps the first n of the sorted files (0: all). The
        sym flags follow the YCB-V table when there are 21 files.

        frame_mode: __getitem__(f) returns samples_per_frame draws of one
        scene (object, base pose, view: what a decoded frame fixes) that
        differ in their per-draw streams (the pose's SE(3) augmentation,
        the resample, the noise), as the raw-mode readers' samples_per_frame
        draws do; BatchLoader(samples_per_item=samples_per_frame) keeps each
        frame's draws in one batch."""
        self.frame_mode = bool(frame_mode)
        self.samples_per_frame = int(samples_per_frame)
        self.n_points = n_points
        self.unit = np.asarray(unit_voxel_extent, np.float32)
        self.limit = np.asarray(voxel_num_limit, np.int32)
        self.total = self.unit * self.limit
        self.length = length
        self.noise = noise
        rng = np.random.RandomState(seed)
        self.cad_points = []
        self.cad_colors = []
        self.sym_flags = []
        imagenet_mean = np.array([0.485, 0.456, 0.406], np.float32)
        if cad_dir is not None:
            import glob
            import os

            from dcl_net_tpu_torch.data.ply import read_ply
            from dcl_net_tpu_torch.data.ycbv import NUM_CLASSES, SYMMETRY_OBJ_IDX

            all_paths = sorted(glob.glob(os.path.join(cad_dir, "*_pc.ply")))
            if not all_paths:
                raise FileNotFoundError(f"no *_pc.ply in {cad_dir}")
            # sym flags index the FULL sorted class list, so detect the
            # YCB-V set before any truncation
            is_ycbv = len(all_paths) == NUM_CLASSES
            paths = all_paths[:n_objects] if n_objects else all_paths
            for i, p in enumerate(paths):
                ply = read_ply(p)
                pts = ply["points"].astype(np.float32)
                cols = ply.get("colors", np.full_like(pts, 0.5)).astype(np.float32)
                self.cad_points.append(pts)
                self.cad_colors.append(cols - imagenet_mean)
                self.sym_flags.append(1.0 if (is_ycbv and i in SYMMETRY_OBJ_IDX) else 0.0)
            return
        for _ in range(n_objects):
            pts, cols = _sample_superquadric(rng, 4096)
            self.cad_points.append(pts)
            self.cad_colors.append(cols - imagenet_mean)
            self.sym_flags.append(1.0 if rng.rand() < sym_ratio else 0.0)

    def __len__(self) -> int:
        return self.length

    def _voxel_index(self, pts: np.ndarray) -> np.ndarray:
        idx = np.floor((pts + 0.5 * self.total) / self.unit).astype(np.int32)
        return np.clip(idx, 0, self.limit - 1)

    def __getitem__(self, index: int):
        from scipy.spatial.transform import Rotation

        if self.frame_mode:
            return self._frame_item(index)
        rng = np.random.RandomState(index & 0x7FFFFFFF)
        obj = rng.randint(len(self.cad_points))
        cad = self.cad_points[obj]
        col = self.cad_colors[obj]
        n = self.n_points

        tsel = rng.choice(len(cad), n, replace=n > len(cad))
        tmp_pts, tmp_col = cad[tsel], col[tsel]

        # observed: random pose + half-space visibility + noise
        rot = Rotation.random(random_state=rng).as_matrix().astype(np.float32)
        trans = (rng.rand(3).astype(np.float32) - 0.5) * 0.06
        view = rng.randn(3).astype(np.float32)
        view /= np.linalg.norm(view)
        visible = (cad @ view) > np.percentile(cad @ view, 40)
        vis_idx = np.where(visible)[0]
        osel = vis_idx[rng.choice(len(vis_idx), n, replace=True)]
        obs = cad[osel] @ rot.T + trans
        obs = obs + rng.randn(n, 3).astype(np.float32) * self.noise
        obs_col = col[osel]

        ones = np.ones((n, 1), np.float32)
        return {
            "inp_feats": np.concatenate([ones, obs_col, obs], -1),
            "inp_voxel_idx": self._voxel_index(obs),
            "tmp_feats": np.concatenate([ones, tmp_col, tmp_pts], -1),
            "tmp_voxel_idx": self._voxel_index(tmp_pts),
            "rot_gt": rot,
            "trans_gt": trans,
            "obj_idx": np.int32(obj),
            "sym_flag": np.float32(self.sym_flags[obj]),
            "valid": 1.0,
            "radius": np.float32(np.linalg.norm(cad, axis=1).max()),
        }

    def _frame_item(self, index: int):
        """One synthetic frame: the scene from RandomState(index), then
        samples_per_frame draws, each from a RandomState of its own: an
        Euler perturbation of +-5 degrees and a translation jitter of +-3 cm
        of the pose (the device path's augmentation), the template and
        observed resamples and the noise. A list of the draws (one: the
        bare sample)."""
        from scipy.spatial.transform import Rotation

        scene = np.random.RandomState(index & 0x7FFFFFFF)
        obj = scene.randint(len(self.cad_points))
        cad = self.cad_points[obj]
        col = self.cad_colors[obj]
        n = self.n_points
        rot = Rotation.random(random_state=scene).as_matrix().astype(np.float32)
        trans = (scene.rand(3).astype(np.float32) - 0.5) * 0.06
        view = scene.randn(3).astype(np.float32)
        view /= np.linalg.norm(view)
        visible = (cad @ view) > np.percentile(cad @ view, 40)
        vis_idx = np.where(visible)[0]

        out = []
        for j in range(self.samples_per_frame):
            draw = np.random.RandomState((index * 1000003 + 7919 * j + 1) & 0x7FFFFFFF)
            ang = draw.uniform(-np.pi / 36, np.pi / 36, 3)
            aug_r = Rotation.from_euler("xyz", ang).as_matrix().astype(np.float32)
            rot_j = (rot @ aug_r).astype(np.float32)
            trans_j = trans + draw.uniform(-0.03, 0.03, 3).astype(np.float32)
            tsel = draw.choice(len(cad), n, replace=n > len(cad))
            osel = vis_idx[draw.choice(len(vis_idx), n, replace=True)]
            obs = cad[osel] @ rot_j.T + trans_j
            obs = obs + draw.randn(n, 3).astype(np.float32) * self.noise
            ones = np.ones((n, 1), np.float32)
            out.append({
                "inp_feats": np.concatenate([ones, col[osel], obs], -1),
                "inp_voxel_idx": self._voxel_index(obs),
                "tmp_feats": np.concatenate([ones, col[tsel], cad[tsel]], -1),
                "tmp_voxel_idx": self._voxel_index(cad[tsel]),
                "rot_gt": rot_j,
                "trans_gt": trans_j.astype(np.float32),
                "obj_idx": np.int32(obj),
                "sym_flag": np.float32(self.sym_flags[obj]),
                "valid": 1.0,
                "radius": np.float32(np.linalg.norm(cad, axis=1).max()),
            })
        return out if self.samples_per_frame > 1 else out[0]

    def template_bank(self) -> Dict[str, np.ndarray]:
        """Per-class template inputs {"feats": [C, M, 7], "voxel_idx":
        [C, M, 3]}: one fixed draw of each class's cloud."""
        feats, vidx = [], []
        for obj in range(len(self.cad_points)):
            rng = np.random.RandomState(obj)
            sel = rng.choice(len(self.cad_points[obj]), self.n_points,
                             replace=self.n_points > len(self.cad_points[obj]))
            pts = self.cad_points[obj][sel]
            col = self.cad_colors[obj][sel]
            ones = np.ones((self.n_points, 1), np.float32)
            feats.append(np.concatenate([ones, col, pts], -1))
            vidx.append(self._voxel_index(pts))
        return {"feats": np.stack(feats), "voxel_idx": np.stack(vidx)}

    def model_points(self, obj: int, n: int, seed: int = 0) -> np.ndarray:
        """CAD cloud for eval metrics."""
        rng = np.random.RandomState(seed)
        cad = self.cad_points[obj]
        sel = rng.choice(len(cad), n, replace=n > len(cad))
        return cad[sel]
