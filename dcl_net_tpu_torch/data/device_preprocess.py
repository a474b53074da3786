"""Device-side input preprocessing: lift -> center -> aug -> filter ->
resample -> assemble, on the device for a whole batch.

Counterpart of dcl_net_tpu/data/device_preprocess.py. The host keeps the
PNG/.mat decode, the instance choice, the bbox snap and the gather of the
mask's candidate pixels (depth u16, row/col i16, rgb u8, padded to
device_cand_k: the readers' raw-candidate mode); this module does the rest
of data/preprocess.py's numpy tail on the device, batched over B: the depth
lift (reference YCBV/dataloader_train_YCBV.py:146-154), the masked centroid
centering (:157-159), the SE(3) augmentation (:161-177), the volume filter
and the fixed-N resample (:189-199), and the feature and voxel-index
assembly (:202-205).

It is plain torch on an explicit device, f32 with TF32 off (strict_f32):
the JAX module's einsums run at precision HIGHEST.

Randomness: the production draws come from a torch.Generator on the
device, seeded from rd_seed. They match numpy's rng.choice in distribution
only, as the JAX module's draws do: uniform WITHOUT replacement (the top N
of uniform keys over the kept set) when more than N candidates are kept,
iid WITH replacement over the kept set otherwise (the host path, and the
reference, draw with replacement at exactly N too). For parity tests
preprocess_core takes the draws instead (aug angles, translation jitter,
candidate indices).

DevicePreprocessor runs in the loader's producer thread, on a CUDA stream
of its own; the batch it returns is a schema.DeviceBatch, which the
consumer's schema.batch_to_torch hands over to its stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dcl_net_tpu_torch import resolve_device, strict_f32
from dcl_net_tpu_torch.data.preprocess import IMAGENET_MEAN
from dcl_net_tpu_torch.data.schema import DeviceBatch

# the raw-batch arrays preprocess_core reads
RAW_KEYS = ("cand_depth", "cand_rc", "cand_rgb", "n_cand", "cam", "rot_gt",
            "trans_gt", "valid")


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Extrinsic-xyz Euler angles [..., 3] -> rotation matrices [..., 3, 3]:
    R = Rz(a3) @ Ry(a2) @ Rx(a1), scipy's Rotation.from_euler("xyz", a)
    (the reference aug convention, YCBV/dataloader_train_YCBV.py:161-166)."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _lift(raw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Depth -> camera-frame cloud [B, K, 3] at the candidate pixels
    (reference YCBV/dataloader_train_YCBV.py:146-154; the row index pairs
    with cy/fy, the column with cx/fx)."""
    cam = raw["cam"].to(torch.float32)
    depth = raw["cand_depth"].to(torch.float32)
    row = raw["cand_rc"][..., 0].to(torch.float32)
    col = raw["cand_rc"][..., 1].to(torch.float32)
    cx, cy, fx, fy, scale = (cam[:, i:i + 1] for i in range(5))
    pt2 = depth / scale
    pt0 = (col - cx) * pt2 / fx
    pt1 = (row - cy) * pt2 / fy
    return torch.stack([pt0, pt1, pt2], dim=-1)


def _assemble(cloud: torch.Tensor, rgb: torch.Tensor, unit: torch.Tensor,
              total: np.ndarray, limit: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[1, rgb, xyz] features and clipped int32 voxel indices (data/
    preprocess.py::assemble_features: the int cast truncates toward zero,
    and total[0] offsets every axis, as in the reference)."""
    ones = torch.ones(cloud.shape[:-1] + (1,), dtype=torch.float32, device=cloud.device)
    feats = torch.cat([ones, rgb, cloud], dim=-1)
    vidx = ((cloud + float(total[0] * np.float32(0.5))) / unit).to(torch.int32)
    hi = torch.tensor([int(v) - 1 for v in limit], dtype=torch.int32, device=cloud.device)
    return feats, torch.minimum(torch.clamp(vidx, min=0), hi)


def _draw_cand_idx(keep: torch.Tensor, n_points: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """n_points candidate indices [B, N] per row from its kept set: uniform
    without replacement when more than n_points are kept (the top N of
    uniform keys), iid with replacement otherwise (the j-th kept candidate,
    j uniform over the kept count). A row that keeps nothing draws index 0;
    preprocess_core marks it invalid."""
    b, k = keep.shape
    dev = keep.device
    count = keep.sum(dim=1)
    keys = torch.where(keep, torch.rand((b, k), generator=generator, device=dev),
                       torch.full((), -1.0, device=dev))
    wo = torch.topk(keys, n_points, dim=1).indices
    cdf = torch.cumsum(keep.to(torch.int32), dim=1)
    u = torch.rand((b, n_points), generator=generator, device=dev)
    cnt = count[:, None].to(torch.float32)
    j = torch.minimum(torch.floor(u * cnt), cnt - 1).to(torch.int32)
    wr = torch.searchsorted(cdf, j.contiguous(), right=True).clamp(max=k - 1)
    return torch.where((count > n_points)[:, None], wo, wr)


def preprocess_core(raw: Dict[str, torch.Tensor], aug_angles: Optional[torch.Tensor],
                    aug_trans: Optional[torch.Tensor], cand_idx: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None, *, n_points: int,
                    unit: Sequence[float], total: Sequence[float], limit: Sequence[int],
                    augment: bool, min_points: int, eval_keep_clamp: bool,
                    keep_clamp_threshold: int = 32) -> Dict[str, torch.Tensor]:
    """The preprocessing of one raw batch given its draws.

    raw: the RAW_KEYS of make_raw_batch as tensors on one device.
    aug_angles [B, 3] and aug_trans [B, 3]: the augmentation's draws (used
    when augment). cand_idx [B, N]: the resample's candidate indices, or
    None to draw them from `generator` (production).
    eval_keep_clamp: the eval readers' quirk, applying the volume filter
    only when more than keep_clamp_threshold candidates survive it, else
    keeping every candidate (YCB-V test: 32, reference
    YCBV/dataloader_test_YCBV.py:164-180; LM eval: 0, reference
    LM/dataloader_test_LM.py:195-204); a row is then invalid only without
    candidates. Otherwise a row with min_points or fewer survivors is
    invalid (YCB-V train 50, LM 128, LMO eval 0).
    Returns inp_feats [B, N, 7], inp_voxel_idx [B, N, 3] int32, rot_gt,
    trans_gt (augmented, centered) and valid; an invalid row carries the
    first valid row's inputs and its own labels, as schema.make_batch does.
    """
    dev = raw["cand_depth"].device
    unit_t = torch.tensor(unit, dtype=torch.float32, device=dev)
    total_np = np.asarray(total, np.float32)
    k = raw["cand_depth"].shape[1]
    n_cand = raw["n_cand"].to(torch.int32)
    cmask = torch.arange(k, device=dev)[None, :] < n_cand[:, None]

    cloud = _lift(raw)
    denom = torch.clamp(n_cand.to(torch.float32), min=1.0)[:, None]
    centroid = torch.where(cmask[..., None], cloud, torch.zeros((), device=dev)).sum(1) / denom
    cloud = cloud - centroid[:, None, :]
    trans = raw["trans_gt"].to(torch.float32) - centroid
    rot = raw["rot_gt"].to(torch.float32)

    if augment:
        # canonicalise by the current pose, jitter t, right-multiply R by
        # the Euler perturbation, re-pose (reference :161-177)
        aug_r = euler_xyz_to_matrix(aug_angles.to(torch.float32))
        cloud_obj = torch.einsum("bki,bij->bkj", cloud - trans[:, None, :], rot)
        trans = trans + aug_trans.to(torch.float32)
        rot = torch.einsum("bij,bjk->bik", rot, aug_r)
        cloud = torch.einsum("bki,bji->bkj", cloud_obj, rot) + trans[:, None, :]

    half = total_np * np.float32(0.5)
    inside = ((cloud[..., 0].abs() < float(half[0])) & (cloud[..., 1].abs() < float(half[1]))
              & (cloud[..., 2].abs() < float(half[2])))
    keep = cmask & inside
    keep_count = keep.sum(dim=1)
    if eval_keep_clamp:
        keep = torch.where((keep_count > keep_clamp_threshold)[:, None], keep, cmask)
        dev_valid = n_cand > 0
    else:
        dev_valid = keep_count > min_points

    if cand_idx is None:
        cand_idx = _draw_cand_idx(keep, n_points, generator)
    sel = cand_idx.to(torch.int64)[..., None].expand(-1, -1, 3)
    sel_cloud = torch.gather(cloud, 1, sel)
    rgb = raw["cand_rgb"].to(torch.float32) / 255.0 - torch.from_numpy(IMAGENET_MEAN).to(dev)
    sel_rgb = torch.gather(rgb, 1, sel)
    feats, vidx = _assemble(sel_cloud, sel_rgb, unit_t, total_np, limit)

    # invalid rows carry a valid row's inputs (keeps the BN statistics sane)
    # while their labels stay their own
    valid = raw["valid"].to(torch.float32) * dev_valid.to(torch.float32)
    tpl = torch.argmax(valid)  # the first maximum, as jnp.argmax
    ok = (valid > 0)[:, None, None]
    return {
        "inp_feats": torch.where(ok, feats, feats[tpl][None]),
        "inp_voxel_idx": torch.where(ok, vidx, vidx[tpl][None]),
        "rot_gt": rot,
        "trans_gt": trans,
        "valid": valid,
    }


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; uint16 (depth) travels as int16 and is
    widened to int32 there (torch's uint16 supports few ops)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).to(torch.int32) & 0xFFFF
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DevicePreprocessor:
    """Batch preprocessor of raw candidate batches (make_raw_batch) on a
    device: collate=make_raw_batch and batch_transform=this in BatchLoader
    or EvalFrameLoader (tools/common.py::build_device_preprocess, under
    device_preprocess: True). Each call draws its augmentation and resample
    from a torch.Generator on the device seeded with `seed`, and returns a
    schema.DeviceBatch of tensors on the device.

    On a CUDA device the work is queued on a stream of the preprocessor's
    own (it runs in the loader's producer thread, beside the train step),
    and the batch carries an event recorded after it; batch_to_torch makes
    the consumer's stream wait for that event and records the batch's
    tensors on that stream, so the caching allocator keeps their memory
    until the consumer's work is done.

    process_id, process_count: data parallelism. Each process preprocesses
    its own block of the global batch, so over several processes the
    generator's seed is derived from (seed, process_id) and every process
    draws its own stream (JAX folds the process index into its key,
    dcl_net_tpu/data/device_preprocess.py:246-255); one process keeps
    `seed`, so seeded records still reproduce."""

    def __init__(self, n_points: int, unit_voxel_extent: Sequence[float],
                 voxel_num_limit: Sequence[int], augment: bool = True,
                 min_points: int = 50, eval_keep_clamp: bool = False,
                 keep_clamp_threshold: int = 32,
                 angle_range: float = float(np.pi / 36.0), trans_range: float = 0.03,
                 seed: int = 0, device=None, process_id: int = 0,
                 process_count: int = 1):
        self.device = resolve_device(device)
        self.unit = tuple(float(u) for u in unit_voxel_extent)
        self.limit = tuple(int(v) for v in voxel_num_limit)
        self.total = tuple(u * v for u, v in zip(self.unit, self.limit))
        self.n_points = int(n_points)
        self.augment = bool(augment)
        self.min_points = int(min_points)
        self.eval_keep_clamp = bool(eval_keep_clamp)
        self.keep_clamp_threshold = int(keep_clamp_threshold)
        self.angle_range, self.trans_range = float(angle_range), float(trans_range)
        if process_count > 1:
            seed = int(np.random.SeedSequence((int(seed), int(process_id))).generate_state(1)[0])
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        strict_f32()

    def _uniform(self, b: int, r: float) -> torch.Tensor:
        u = torch.rand((b, 3), generator=self.generator, device=self.device)
        return u * (2.0 * r) - r

    def _run(self, raw_batch: Dict[str, np.ndarray]) -> DeviceBatch:
        dev = self.device
        raw = {k: _to_device(raw_batch[k], dev) for k in RAW_KEYS}
        b = raw["valid"].shape[0]
        angles = tr = None
        if self.augment:
            angles = self._uniform(b, self.angle_range)
            tr = self._uniform(b, self.trans_range)
        out = preprocess_core(
            raw, angles, tr, None, self.generator, n_points=self.n_points, unit=self.unit,
            total=self.total, limit=self.limit, augment=self.augment,
            min_points=self.min_points, eval_keep_clamp=self.eval_keep_clamp,
            keep_clamp_threshold=self.keep_clamp_threshold)
        pad = raw_batch.get("pad")
        pad = np.zeros(b, np.float32) if pad is None else pad
        return DeviceBatch({
            "inp": {"feats": out["inp_feats"], "voxel_idx": out["inp_voxel_idx"]},
            "tmp": {"feats": _to_device(raw_batch["tmp_feats"].astype(np.float32), dev),
                    "voxel_idx": _to_device(raw_batch["tmp_voxel_idx"].astype(np.int32), dev)},
            "labels": {"rot_gt": out["rot_gt"], "trans_gt": out["trans_gt"],
                       "obj_idx": _to_device(raw_batch["obj_idx"].astype(np.int32), dev)},
            "sym_flag": _to_device(raw_batch["sym_flag"].astype(np.float32), dev),
            "valid": out["valid"],
            "pad": _to_device(np.asarray(pad, np.float32), dev),
        })

    def __call__(self, raw_batch: Dict[str, np.ndarray]) -> DeviceBatch:
        if self.stream is None:
            return self._run(raw_batch)
        with torch.cuda.stream(self.stream):
            batch = self._run(raw_batch)
            batch.ready = torch.cuda.Event()
            batch.ready.record(self.stream)
        return batch


def make_raw_batch(samples, pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack raw candidate samples (the readers' raw mode) into a
    fixed-shape dict of numpy arrays for DevicePreprocessor. An invalid row
    and each fill row up to pad_to carry the first valid sample's inputs
    (raw pixels and template branch) with valid = 0; labels stay each row's
    own (schema.make_batch's convention)."""
    if not samples:
        raise ValueError("batch contains no samples")
    valid_samples = [s for s in samples if s.get("valid", 1.0) > 0]
    template = valid_samples[0] if valid_samples else samples[0]
    if pad_to is not None and pad_to < len(samples):
        raise ValueError(f"pad_to={pad_to} < {len(samples)} samples")
    b = pad_to or len(samples)
    # an invalid raw sample carries all-zero template grids, which would
    # pollute the template encoder's train-mode BN statistics
    input_keys = {"cand_depth", "cand_rc", "cand_rgb", "n_cand", "cam",
                  "tmp_feats", "tmp_voxel_idx"}
    rows, pad_flags = [], []
    for i in range(b):
        if i < len(samples):
            s = samples[i]
            if s.get("valid", 1.0) <= 0:
                s = dict(s)
                for kk in input_keys:
                    s[kk] = template[kk]
            rows.append(s)
            pad_flags.append(0.0)
        else:
            rows.append(template)
            pad_flags.append(1.0)

    def stack(key, dtype=None):
        return np.stack([np.asarray(s[key], dtype=dtype) for s in rows])

    out = {
        "cand_depth": stack("cand_depth", np.uint16),
        "cand_rc": stack("cand_rc", np.int16),
        "cand_rgb": stack("cand_rgb", np.uint8),
        "n_cand": stack("n_cand", np.int32).reshape(b),
        "cam": stack("cam", np.float32),
        "rot_gt": stack("rot_gt", np.float32),
        "trans_gt": stack("trans_gt", np.float32),
        "obj_idx": stack("obj_idx", np.int32).reshape(b),
        "sym_flag": stack("sym_flag", np.float32).reshape(b),
        "valid": np.asarray([float(s.get("valid", 1.0)) for s in rows], np.float32),
        "tmp_feats": stack("tmp_feats", np.float32),
        "tmp_voxel_idx": stack("tmp_voxel_idx", np.int32),
        "pad": np.asarray(pad_flags, np.float32),
    }
    out["valid"] = out["valid"] * (1.0 - out["pad"])
    if "radius" in template:
        out["radius"] = stack("radius", np.float32).reshape(b)
    return out
