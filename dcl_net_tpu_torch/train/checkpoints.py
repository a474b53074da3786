"""Checkpoints of a training run, with torch.save.

Counterpart of the orbax checkpoints of dcl_net_tpu/train/checkpoints.py,
in the same layout: <dir>/epoch_<n>/ holds one file, state.pt, with
{"model": state_dict, "opt_state": {...}, "step", "epoch", "meta"}, where
meta["consumed_batches"] > 0 marks a mid-epoch checkpoint. "model" is the
trained module's state: the DCLNet in stage 1, the Refiner in stage 2
(tools/train_ycbv_stage2.py), whose stage-1 model is loaded from a stage-1
checkpoint's "model". Converting the reference .pth weights is not ported
yet.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

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
