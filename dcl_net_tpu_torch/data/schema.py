"""The batch data contract between the data pipeline and the models.

The port's own copy of dcl_net_tpu/data/schema.py: fixed [B, N, ...] host
batches with per-point voxel indices, `valid` flags instead of dropped
samples, and `pad` flags for fill rows; batch_to_torch moves one onto a
device. A DeviceBatch is a batch whose tensors a producer already made on
the device (data/device_preprocess.py), on a stream of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


@dataclass
class PoseBatch:
    """Host-side batch. All arrays are numpy; `to_dict` feeds the model."""

    inp_feats: np.ndarray      # [B, N, 7]  (1, rgb-mean-subtracted, xyz)
    inp_voxel_idx: np.ndarray  # [B, N, 3]  int32
    tmp_feats: np.ndarray      # [B, M, 7]
    tmp_voxel_idx: np.ndarray  # [B, M, 3]  int32
    rot_gt: np.ndarray         # [B, 3, 3]
    trans_gt: np.ndarray       # [B, 3]
    obj_idx: np.ndarray        # [B] int32
    sym_flag: np.ndarray       # [B] float32 (1 = symmetric)
    valid: np.ndarray          # [B] float32 (0 = padded/invalid row)
    radius: Optional[np.ndarray] = None  # [B] object radius
    # 1.0 for fill rows added by pad_to: valid=0 alone cannot tell a genuine
    # lost detection (scored by the protocol) from a row that only makes
    # the batch rectangular (skipped entirely).
    pad: Optional[np.ndarray] = None  # [B] float32

    def to_dict(self) -> Dict[str, Any]:
        b = self.valid.shape[0]
        return {
            "inp": {"feats": self.inp_feats, "voxel_idx": self.inp_voxel_idx},
            "tmp": {"feats": self.tmp_feats, "voxel_idx": self.tmp_voxel_idx},
            "labels": {
                "rot_gt": self.rot_gt,
                "trans_gt": self.trans_gt,
                "obj_idx": self.obj_idx,
            },
            "sym_flag": self.sym_flag,
            "valid": self.valid,
            "pad": (self.pad if self.pad is not None
                    else np.zeros(b, np.float32)),
        }


def make_batch(samples, pad_to: Optional[int] = None) -> PoseBatch:
    """Stack per-sample dicts into a PoseBatch, padding to a fixed size.

    Invalid samples are kept with valid=0 and their labels, their inputs
    replaced by the first valid sample's; fill rows up to pad_to replicate
    that sample with valid=0 and pad=1."""
    if not samples:
        raise ValueError("batch contains no samples")
    valid_samples = [s for s in samples if s.get("valid", 1.0) > 0]
    template = valid_samples[0] if valid_samples else samples[0]
    if pad_to is not None and pad_to < len(samples):
        raise ValueError(
            f"pad_to={pad_to} would silently drop "
            f"{len(samples) - pad_to} of {len(samples)} samples"
        )
    b = pad_to or len(samples)

    input_keys = {"inp_feats", "inp_voxel_idx", "tmp_feats", "tmp_voxel_idx"}
    rows = []
    pad_flags = []
    for i in range(b):
        if i < len(samples) and samples[i].get("valid", 1.0) > 0:
            rows.append((samples[i], 1.0))
            pad_flags.append(0.0)
        elif i < len(samples):
            merged = dict(samples[i])
            for k in input_keys:
                merged[k] = template[k]
            rows.append((merged, 0.0))
            pad_flags.append(0.0)  # genuine invalid row (lost detection)
        else:
            rows.append((template, 0.0))
            pad_flags.append(1.0)  # fill row, skipped by eval

    def stack(key, dtype=np.float32):
        return np.stack([np.asarray(s[key], dtype=dtype) for s, _ in rows])

    return PoseBatch(
        inp_feats=stack("inp_feats"),
        inp_voxel_idx=stack("inp_voxel_idx", np.int32),
        tmp_feats=stack("tmp_feats"),
        tmp_voxel_idx=stack("tmp_voxel_idx", np.int32),
        rot_gt=stack("rot_gt"),
        trans_gt=stack("trans_gt"),
        obj_idx=stack("obj_idx", np.int32).reshape(b),
        sym_flag=stack("sym_flag").reshape(b),
        valid=np.asarray([v for _, v in rows], np.float32),
        radius=stack("radius") if "radius" in template else None,
        pad=np.asarray(pad_flags, np.float32),
    )


class DeviceBatch(dict):
    """A batch dict whose tensors already lie on the device, made by a
    producer thread on a CUDA stream of its own; `ready` is the event that
    stream recorded after the batch (None when no stream was used).

    hand_over(stream) makes `stream` wait for that event and records every
    tensor of the batch on it, so the caching allocator does not reuse the
    memory of a tensor the consumer's queued work still reads once the
    producer drops it."""

    ready = None

    def hand_over(self, stream) -> None:
        if self.ready is None:
            return
        stream.wait_event(self.ready)

        def record(x):
            if isinstance(x, Mapping):
                for v in x.values():
                    record(v)
            elif isinstance(x, torch.Tensor):
                x.record_stream(stream)

        record(self)
        self.ready = None


def batch_to_torch(batch: Mapping[str, Any], device,
                   non_blocking: bool = False) -> Dict[str, Any]:
    """Nested dict of arrays -> the same dict of tensors on `device`
    (floats as f32, integers as int32, contiguous). Tensors already on
    `device` are taken as they are, without a copy; a DeviceBatch is first
    handed over to the current stream of `device` (DeviceBatch.hand_over),
    without a host sync.

    non_blocking: for a CUDA device, stage the arrays in pinned memory and
    copy them asynchronously, so the host does not wait for the work
    already queued on the stream (a copy from pageable memory would)."""
    device = torch.device(device)
    asynchronous = non_blocking and device.type == "cuda"
    if isinstance(batch, DeviceBatch) and device.type == "cuda":
        batch.hand_over(torch.cuda.current_stream(device))

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.to(device)
        a = np.asarray(x)
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if asynchronous:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {k: conv(v) for k, v in batch.items() if v is not None}
