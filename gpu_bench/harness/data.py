"""Rows of synthetic pose data, made from the run's seed.

A frozen copy of the superquadric objects and observed clouds of
dcl_net_tpu_torch/data/synthetic.py (_sample_superquadric and
SyntheticPoseDataset.__getitem__ / template_bank), taken into the benchmark
so that a later change to the program cannot change the yardstick. The
draws differ from the program's (one numpy Generator a row, any seed
size); the geometry is the same: a superquadric surface of 4096 points
with colours, a random rigid pose, the 60 % of the surface that faces a
random view, 2 mm of noise, features [1, rgb - imagenet mean, xyz] and
voxel indices floor((p + extent / 2) / unit) clipped to the grid. The
object size range comes from the configuration's `assumed` block.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
SURFACE_POINTS = 4096


def _sample_superquadric(rng: np.random.Generator, n: int, half_axes: Sequence[float]):
    e1, e2 = rng.uniform(0.4, 1.6, 2)
    scale = rng.uniform(half_axes[0], half_axes[1], 3)
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


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform rotation from a normalised Gaussian quaternion."""
    w, x, y, z = rng.standard_normal(4)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class Objects:
    """The classes of a run: one superquadric each, drawn from the seed.

    config: the configuration file's dict (model.unit_voxel_extent,
    model.voxel_num_limit, model.n_inp, num_classes, assumed)."""

    def __init__(self, config: Dict, seed: int):
        model = config["model"]
        assumed = config["assumed"]
        self.n_points = int(model["n_inp"])
        self.unit = np.asarray(model["unit_voxel_extent"], np.float32)
        self.limit = np.asarray(model["voxel_num_limit"], np.int32)
        self.total = self.unit * self.limit
        self.noise = float(assumed["noise_m"])
        self.n_model_points = int(assumed["model_points"])
        n_cls = int(config["num_classes"])
        rng = np.random.default_rng([int(seed), 0])
        self.cad, self.col, self.sym = [], [], []
        for _ in range(n_cls):
            pts, cols = _sample_superquadric(rng, SURFACE_POINTS, assumed["object_half_axes_m"])
            self.cad.append(pts)
            self.col.append(cols - IMAGENET_MEAN)
            self.sym.append(1.0 if rng.random() < float(assumed["sym_ratio"]) else 0.0)

    def voxel_index(self, pts: np.ndarray) -> np.ndarray:
        idx = np.floor((pts + 0.5 * self.total) / self.unit).astype(np.int32)
        return np.clip(idx, 0, self.limit - 1)

    def row(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One instance: a class, its pose, the observed cloud and a
        template draw of the class's surface."""
        obj = int(rng.integers(len(self.cad)))
        cad, col, n = self.cad[obj], self.col[obj], self.n_points
        tsel = rng.choice(len(cad), n, replace=n > len(cad))
        rot = _random_rotation(rng)
        trans = ((rng.random(3) - 0.5) * 0.06).astype(np.float32)
        view = rng.standard_normal(3).astype(np.float32)
        view /= np.linalg.norm(view)
        facing = cad @ view
        vis_idx = np.where(facing > np.percentile(facing, 40))[0]
        osel = vis_idx[rng.choice(len(vis_idx), n, replace=True)]
        obs = cad[osel] @ rot.T + trans
        obs = (obs + rng.standard_normal((n, 3)) * self.noise).astype(np.float32)
        ones = np.ones((n, 1), np.float32)
        return {
            "inp_feats": np.concatenate([ones, col[osel], obs], -1),
            "inp_voxel_idx": self.voxel_index(obs),
            "tmp_feats": np.concatenate([ones, col[tsel], cad[tsel]], -1),
            "tmp_voxel_idx": self.voxel_index(cad[tsel]),
            "rot_gt": rot, "trans_gt": trans, "obj_idx": np.int32(obj),
            "sym_flag": np.float32(self.sym[obj]),
        }

    def rows(self, seed: int, stream: int, count: int) -> List[Dict[str, np.ndarray]]:
        """`count` rows, each from a Generator of its own on (seed, stream,
        index), so every row differs and a pool's rows do not depend on
        its length."""
        return [self.row(np.random.default_rng([int(seed), int(stream), i]))
                for i in range(count)]

    def template_bank(self) -> Dict[str, np.ndarray]:
        """{"feats": [C, M, 7], "voxel_idx": [C, M, 3]}: one fixed draw of
        each class's surface, the template the evaluator and the serving
        artifacts encode once."""
        feats, vidx = [], []
        for obj, (cad, col) in enumerate(zip(self.cad, self.col)):
            rng = np.random.default_rng([obj, 1])
            sel = rng.choice(len(cad), self.n_points, replace=self.n_points > len(cad))
            ones = np.ones((self.n_points, 1), np.float32)
            feats.append(np.concatenate([ones, col[sel], cad[sel]], -1))
            vidx.append(self.voxel_index(cad[sel]))
        return {"feats": np.stack(feats), "voxel_idx": np.stack(vidx)}

    def model_points(self) -> np.ndarray:
        """[C, P, 3] CAD clouds that ADD-S is scored against."""
        out = []
        for obj, cad in enumerate(self.cad):
            rng = np.random.default_rng([obj, 2])
            out.append(cad[rng.choice(len(cad), self.n_model_points,
                                      replace=self.n_model_points > len(cad))])
        return np.stack(out).astype(np.float32)


def stack_batch(rows: List[Dict[str, np.ndarray]]) -> Dict[str, object]:
    """Rows -> the program's batch dict (data/schema.py's PoseBatch.to_dict
    layout): every row valid, no fill rows."""
    def st(key, dtype=np.float32):
        return np.stack([np.asarray(r[key], dtype) for r in rows])

    b = len(rows)
    return {
        "inp": {"feats": st("inp_feats"), "voxel_idx": st("inp_voxel_idx", np.int32)},
        "tmp": {"feats": st("tmp_feats"), "voxel_idx": st("tmp_voxel_idx", np.int32)},
        "labels": {"rot_gt": st("rot_gt"), "trans_gt": st("trans_gt"),
                   "obj_idx": st("obj_idx", np.int32).reshape(b)},
        "sym_flag": st("sym_flag").reshape(b),
        "valid": np.ones(b, np.float32),
        "pad": np.zeros(b, np.float32),
    }
