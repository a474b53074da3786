"""Logging, scalar writing and run bookkeeping.

Counterpart of dcl_net_tpu/train/logging.py: a console + file logger, a
scalar writer (scalars.jsonl always, tensorboard as well when it imports),
a source backup per run, seeding, parameter counting and a digest of the
parameters.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Dict, Optional

import torch


def get_logger(level_print: int = logging.INFO, level_save: int = logging.WARNING,
               path_file: Optional[str] = None,
               name_logger: str = "dcl_net_tpu_torch") -> logging.Logger:
    """Console + file logger."""
    logger = logging.getLogger(name_logger)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    handler_view = logging.StreamHandler()
    handler_view.setFormatter(formatter)
    handler_view.setLevel(level_print)
    logger.addHandler(handler_view)
    if path_file:
        os.makedirs(os.path.dirname(path_file) or ".", exist_ok=True)
        handler_save = logging.FileHandler(path_file)
        handler_save.setFormatter(formatter)
        handler_save.setLevel(level_save)
        logger.addHandler(handler_save)
    return logger


class ScalarWriter:
    """JSONL scalar writer with a step counter per mode; mirrors the scalars
    to tensorboard when torch.utils.tensorboard imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._fh = open(self.path, "a")
        self._counters: Dict[str, int] = {}
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:  # tensorboard is optional: scalars.jsonl always
            self._tb = None

    def add_scalars(self, mode: str, scalars: Dict[str, float],
                    step: Optional[int] = None) -> None:
        if step is None:
            step = self._counters.get(mode, 0)
            self._counters[mode] = step + 1
        record = {"mode": mode, "step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{mode}_{k}", float(v), int(step))

    def close(self) -> None:
        self._fh.close()
        if self._tb:
            self._tb.close()


def backup_source(log_dir: str, repo_root: Optional[str] = None) -> None:
    """Copy the port's package into <log_dir>/source_backup."""
    repo_root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    src_pkg = os.path.join(repo_root, "dcl_net_tpu_torch")
    if os.path.isdir(src_pkg):
        shutil.copytree(src_pkg, os.path.join(log_dir, "source_backup", "dcl_net_tpu_torch"),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def parameter_count(model) -> int:
    """Total number of parameters of a module."""
    return sum(p.numel() for p in model.parameters())


def parameter_digest(model) -> str:
    """sha256 of the bytes of a module's parameters, in order: two ranks of
    a data-parallel run hold the same parameters exactly when their digests
    are equal."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
