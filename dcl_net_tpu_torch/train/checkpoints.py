"""Checkpoints of a training run, with torch.save.

Counterpart of the orbax checkpoints of dcl_net_tpu/train/checkpoints.py,
in the same layout: <dir>/epoch_<n>/ holds one file, state.pt, with
{"model": state_dict, "opt_state": {...}, "step", "epoch", "meta"}, where
meta["consumed_batches"] > 0 marks a mid-epoch checkpoint. "model" is the
trained module's state: the DCLNet in stage 1, the Refiner in stage 2
(tools/train_ycbv_stage2.py), whose stage-1 model is loaded from a stage-1
checkpoint's "model".

A released reference .pth goes through convert_reference_state_dict, a copy
of the JAX package's converter that returns the JAX {"params",
"batch_stats"} layout as numpy; weights.py::load_jax_variables then carries
that tree into the port's modules (load_reference_weights).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def save_checkpoint(directory: str, model: torch.nn.Module, state, epoch: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write <directory>/epoch_<epoch>/state.pt (replacing one that is
    there) and return the checkpoint's directory."""
    path = os.path.abspath(os.path.join(directory, f"epoch_{epoch}"))
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "opt_state": {k: v.detach().cpu() for k, v in state.opt_state.items()},
        "step": int(state.step),
        "epoch": int(epoch),
        "meta": {"consumed_batches": 0, **(meta or {})},
    }
    tmp = os.path.join(path, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Read a checkpoint directory written by save_checkpoint."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                         weights_only=True)
    payload.setdefault("meta", {})
    payload["meta"].setdefault("consumed_batches", 0)
    return payload


def latest_checkpoint(directory: str) -> Optional[str]:
    """The epoch_<n> directory with the largest n, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and os.path.isfile(os.path.join(directory, name, STATE_FILE)):
            e = int(m.group(1))
            if best is None or e > best[0]:
                best = (e, os.path.join(directory, name))
    return best[1] if best else None


# ---------------------------------------------------------------------------
# reference .pth -> the JAX variable tree (numpy) -> the port's modules
# ---------------------------------------------------------------------------
_HEAD_NAMES = [
    "regressor_Xo", "regressor_Yc", "regressor_conf", "regressor_conf_bi",
    "neck_fuser", "neck_fuser_bi", "regressor_rot", "regressor_trans",
]
_DISENGAGE_NAMES = [
    "disengage_Xc_p1", "disengage_Xc_m1", "disengage_Xc_p2", "disengage_Xc_m2",
    "disengage_Yo_p1", "disengage_Yo_m1", "disengage_Yo_p2", "disengage_Yo_m2",
]
_REFINER_NAMES = ("MLP_share", "regressor_rot2", "regressor_trans2")


def convert_reference_state_dict(state_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Convert a reference DCL-Net state dict (stage 1, or the refiner's
    MLP_share / regressor_rot2 / regressor_trans2) into the JAX package's
    {"params", "batch_stats"} tree of numpy arrays.

    Layouts: an spconv SubMConv3d/SparseConv3d weight [kz,ky,kx,Cin,Cout]
    is the JAX conv kernel as it is; a Conv3d 1x1 weight [Cout,Cin,1,1,1]
    and a Conv1d 1x1 weight [Cout,Cin,1] become a Dense kernel [Cin,Cout];
    BatchNorm weight/bias -> scale/bias, running_mean/var -> batch_stats.
    A key that cannot be mapped raises KeyError."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(leaf)

    def conv_w(w):
        w = np.asarray(w)
        if w.ndim == 5 and w.shape[2] == 1 and w.shape[3] == 1 and w.shape[4] == 1:
            return w[:, :, 0, 0, 0].T  # Conv3d 1x1 -> Dense
        if w.ndim == 3 and w.shape[2] == 1:
            return w[:, :, 0].T  # Conv1d 1x1 -> Dense
        if w.ndim == 5:
            return w  # spconv kernel [kz,ky,kx,Cin,Cout]
        raise ValueError(f"unexpected conv weight shape {w.shape}")

    sd = {k.replace("module.", ""): np.asarray(v) for k, v in state_dict.items()}

    for key, value in sd.items():
        top = key.split(".")[0]
        if top.startswith("backbone_"):
            # backbone_inp.moduleX.Y.layers.Z.{weight,...}
            m = re.fullmatch(
                r"backbone_(inp|tmp)\.module(\d)\.(\d)\.layers\.(\d)\.(.+)", key)
            if not m:
                raise KeyError(key)
            branch, mod, blk, layer, leaf = m.groups()
            base = (f"backbone_{branch}", f"conv{(int(mod) - 1) * 2 + int(blk)}")
            if leaf == "weight" and layer == "0":
                put(params, base + ("kernel",), conv_w(value))
            elif layer == "1":  # BatchNorm1d
                _put_bn_leaf(put, params, stats, base, leaf, value, key)
            else:
                raise KeyError(key)
        elif top in _DISENGAGE_NAMES:
            # disengage_X.S.layers.L.{weight,...}: S in 0,1 blocks; L 0=conv 1=bn
            m = re.fullmatch(r"(disengage_\w+)\.(\d)\.layers\.(\d)\.(.+)", key)
            if not m:
                raise KeyError(key)
            name, blk, layer, leaf = m.groups()
            if layer == "0" and leaf == "weight":
                put(params, (name, f"Dense_{blk}", "kernel"), conv_w(value))
            elif layer == "1":
                _put_bn_leaf(put, params, stats, (name, f"BatchNorm_{blk}"), leaf, value, key)
            else:
                raise KeyError(key)
        elif top in _HEAD_NAMES or top in _REFINER_NAMES:
            # head MLP: <name>.layers.<i>.{weight,bias,...}; the torch
            # Sequential interleaves Conv1d / act / BN, so conv indices skip
            m = re.fullmatch(r"(\w+)\.layers\.(\d+)\.(.+)", key)
            if not m:
                raise KeyError(key)
            name, seq_idx, leaf = m.groups()
            put(params, (name, "_torch_seq", seq_idx, leaf), value)
        else:
            raise KeyError(f"unmapped reference key: {key}")

    # second pass: a head's Sequential indices -> Dense_i / BatchNorm_i
    for name in list(params.keys()):
        node = params[name]
        if "_torch_seq" not in node:
            continue
        seq = node.pop("_torch_seq")
        dense_i = bn_i = 0
        for seq_idx in sorted(seq.keys(), key=int):
            leaves = seq[seq_idx]
            if "running_mean" in leaves:  # BatchNorm1d
                put(params, (name, f"BatchNorm_{bn_i}", "scale"), leaves["weight"])
                put(params, (name, f"BatchNorm_{bn_i}", "bias"), leaves["bias"])
                put(stats, (name, f"BatchNorm_{bn_i}", "mean"), leaves["running_mean"])
                put(stats, (name, f"BatchNorm_{bn_i}", "var"), leaves["running_var"])
                bn_i += 1
            else:  # Conv1d
                put(params, (name, f"Dense_{dense_i}", "kernel"), conv_w(leaves["weight"]))
                if "bias" in leaves:
                    put(params, (name, f"Dense_{dense_i}", "bias"), leaves["bias"])
                dense_i += 1

    return {"params": params, "batch_stats": stats}


def _put_bn_leaf(put, params, stats, base, leaf, value, key) -> None:
    if leaf == "weight":
        put(params, base + ("scale",), value)
    elif leaf == "bias":
        put(params, base + ("bias",), value)
    elif leaf == "running_mean":
        put(stats, base + ("mean",), value)
    elif leaf == "running_var":
        put(stats, base + ("var",), value)
    elif leaf != "num_batches_tracked":
        raise KeyError(key)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The state dict of a reference .pth as numpy: its "model_state_dict",
    else its "state_dict", else the file's own dict. The file comes from
    elsewhere, so it is read with weights_only=True: one that needs more
    than tensors, containers and numbers raises, naming the file."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(
            f"{path}: holds more than tensors, dicts and numbers; a reference "
            "checkpoint is read with weights_only=True only") from exc
    sd = ckpt.get("model_state_dict") or ckpt.get("state_dict") or ckpt
    return {k: v.numpy() for k, v in sd.items()}


def to_reference_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of convert_reference_state_dict: the port's DCLNet or
    Refiner as a reference-layout state dict of numpy arrays, keyed as the
    reference's modules key theirs (spconv kernels [kz,ky,kx,Cin,Cout],
    Conv3d 1x1 disengagers, Conv1d heads with a ReLU after every layer but
    a head's last and, in the BN heads, BatchNorm1d after the ReLU)."""
    from dcl_net_tpu_torch.weights import to_jax_variables

    variables = to_jax_variables(model)
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def bn(prefix: str, p, s) -> None:
        sd[f"{prefix}.weight"] = p["scale"]
        sd[f"{prefix}.bias"] = p["bias"]
        sd[f"{prefix}.running_mean"] = s["mean"]
        sd[f"{prefix}.running_var"] = s["var"]
        sd[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)

    for name, node in params.items():
        if name.startswith("backbone_"):
            for conv, leaves in node.items():
                i = int(conv[len("conv"):])
                base = f"{name}.module{i // 2 + 1}.{i % 2}.layers"
                sd[f"{base}.0.weight"] = leaves["kernel"]
                bn(f"{base}.1", leaves, stats[name][conv])
        elif name in _DISENGAGE_NAMES:
            for blk in (0, 1):
                base = f"{name}.{blk}.layers"
                sd[f"{base}.0.weight"] = np.ascontiguousarray(
                    node[f"Dense_{blk}"]["kernel"].T[:, :, None, None, None])
                bn(f"{base}.1", node[f"BatchNorm_{blk}"], stats[name][f"BatchNorm_{blk}"])
        else:  # a head: Conv1d, ReLU[, BatchNorm1d] per layer
            stride = 3 if "BatchNorm_0" in node else 2
            dense = sorted((k for k in node if k.startswith("Dense_")),
                           key=lambda k: int(k.split("_")[1]))
            for i, key in enumerate(dense):
                sd[f"{name}.layers.{i * stride}.weight"] = np.ascontiguousarray(
                    node[key]["kernel"].T[:, :, None])
                sd[f"{name}.layers.{i * stride}.bias"] = node[key]["bias"]
                if stride == 3:
                    bn(f"{name}.layers.{i * stride + 2}", node[f"BatchNorm_{i}"],
                       stats[name][f"BatchNorm_{i}"])
    return sd


def load_reference_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Fill the port's DCLNet or Refiner from a reference .pth: convert the
    state dict (convert_reference_state_dict), then carry the JAX-layout
    tree across (weights.py::load_jax_variables). A key of either side
    with no counterpart raises."""
    from dcl_net_tpu_torch.weights import load_jax_variables

    return load_jax_variables(model, convert_reference_state_dict(load_torch_checkpoint(path)))
