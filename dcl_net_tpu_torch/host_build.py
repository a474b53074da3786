"""Build a host (CPU) library of dcl_net_tpu_torch/csrc/host/ with a C++
compiler (``$CXX``, else ``g++``) at first use, into
``dcl_net_tpu_torch/build/`` under a name that hashes its sources and the
flags. The compiler writes a temporary file that is renamed into place, so
processes that build at once never load a half-written library. The PNG
decoder (data/png.py) and the host voxelizer (ops/cpu_voxelizer.py) are
built this way; a library that cannot be built raises, with the
compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE_DIR = PACKAGE_DIR / "csrc" / "host"
BUILD_DIR = PACKAGE_DIR / "build"
# no -march=native: a library built on one host must load on another
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_BUILD_LOCK = threading.Lock()


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(sources: Sequence[str], stem: str, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of these csrc/host/ sources lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in sources:
        h.update(name.encode())
        h.update((SOURCE_DIR / name).read_bytes())
    return Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str], stem: str, what: str, libs: Sequence[str] = (),
          cxx: str = None, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library of these csrc/host/ sources (linked with `libs`)
    if it is missing and return its path. Raises RuntimeError naming `what`,
    with the compiler's output, when the compiler is missing or fails."""
    so = library_path(sources, stem, build_dir)
    if so.exists():
        return so
    cxx = cxx or compiler()
    with _BUILD_LOCK:
        if so.exists():
            return so
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
               *(str(SOURCE_DIR / s) for s in sources), *libs]
        try:
            out = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        except OSError as exc:
            raise RuntimeError(
                f"{what} needs a C++ compiler: {' '.join(cmd)}: {exc}") from exc
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {what} failed: {' '.join(cmd)}\n{out.stdout}")
        os.replace(tmp, so)
    return so
