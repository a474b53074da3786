"""The run's environment: cache directories, the card, and the import check.

Imports nothing heavy, so run.py can call prepare() before torch loads.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, Iterable, List

from gpu_bench.harness.spec import ROOT

# top-level module names that no benchmark process may hold: the JAX stack
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dcl_net_tpu")

# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc library lives in dcl_net_tpu_torch/build/ there already)
CACHE_DIR = ROOT / ".bench_cache"
CACHE_VARS = {
    "TORCH_EXTENSIONS_DIR": CACHE_DIR / "torch_extensions",
    "TRITON_CACHE_DIR": CACHE_DIR / "triton",
    "TORCHINDUCTOR_CACHE_DIR": CACHE_DIR / "inductor",
}


def prepare() -> None:
    """Point the build caches into the checkout and keep libraries that
    could load JAX from doing so."""
    for var, path in CACHE_VARS.items():
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: dcl_net_tpu_torch is not dcl_net_tpu."""
    names = sys.modules if names is None else names
    tops = {n.split(".")[0] for n in names}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_record(torch, count: int) -> Dict[str, object]:
    """The result line's `device`: platform, card name, cards used and the
    peak memory of the fullest card."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}
