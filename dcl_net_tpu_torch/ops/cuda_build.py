"""Build and load the hand-written CUDA kernels of the port.

The sources in ``dcl_net_tpu_torch/csrc/*.cu`` have a plain C interface. At
first use each one is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, the objects are linked into one shared library
under ``dcl_net_tpu_torch/build/`` (named by a hash of the sources, the
headers they include and the flags, so an edit rebuilds), and the library is loaded with ``ctypes``.
Nothing here runs when the package is imported: the CPU path never needs a
compiler or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("voxelize.cu", "compact.cu", "interp.cu", "fused.cu")
HEADERS = ("three_nn_lanes.cuh",  # included by interp.cu and fused.cu
           "inverse_index.cuh",  # included by interp.cu and fused.cu
           "tile_fill.cuh",  # included by voxelize.cu, compact.cu and fused.cu
           "elem.cuh")  # f32 / bf16 element helpers, included by all four
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer and the stream as c_void_p, sizes as c_int,
# f32 constants as c_float.
# A "_bf16" entry point is its kernel's bf16 variant, with the same
# arguments.
SIGNATURES = {
    "dclx_voxelize": [_P] * 5 + [_I] * 11 + [_P],
    "dclx_voxelize_bf16": [_P] * 5 + [_I] * 11 + [_P],
    "dclx_compact": [_P] * 6 + [_I] * 7 + [_P],
    "dclx_compact_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "dclx_interp": [_P] * 8 + [_I] * 6 + [_P],
    "dclx_interp_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "dclx_inverse_index": [_P] * 2 + [_I] * 3 + [_P],
    "dclx_interp_bwd": [_P] * 5 + [_I] * 5 + [_P],
    "dclx_interp_bwd_bf16": [_P] * 5 + [_I] * 5 + [_P],
    "dclx_compact_bwd": [_P] * 4 + [_I] * 7 + [_P],
    "dclx_compact_bwd_bf16": [_P] * 4 + [_I] * 7 + [_P],
    "dclx_compact_interp": [_P] * 8 + [_I] * 6 + [_F] * 6 + [_P],
    "dclx_compact_interp_bf16": [_P] * 8 + [_I] * 6 + [_F] * 6 + [_P],
    "dclx_compact_interp_bwd": [_P] * 7 + [_I] * 8 + [_P],
    "dclx_compact_interp_bwd_bf16": [_P] * 7 + [_I] * 8 + [_P],
}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of dcl_net_tpu_torch are built with "
        "nvcc at first use (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libdclx_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for these sources is missing.

    verbose: pass ``-Xptxas -v`` and print what nvcc reports (registers,
    shared memory, spills per kernel). Returns the library's path."""
    so = library_path()
    if so.exists():
        return so
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    objs: List[Path] = []
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{os.getpid()}.o"
        cmd = [exe, *NVCC_FLAGS, *extra, "-Xcompiler", "-fPIC", "-c",
               str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for name, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(f"[nvcc {name}]\n{out}", flush=True)
        if p.returncode != 0:
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [exe, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def entry_point(name: str):
    """The C entry point `name` of the loaded library, resolved once."""
    return getattr(library(), name)


def launch(entry: str, kernel: str, device, *args) -> None:
    """Call the C entry point on `device`'s current stream, with that device
    current, and raise if it reports a CUDA error (cudaGetLastError). The
    device is made current only where it is not already."""
    import torch

    fn = entry_point(entry)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # the raw handle of the current stream, as torch's own generated kernel
    # launchers read it (torch.cuda.current_stream builds a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def require(cond: bool, kernel: str, what) -> None:
    """Raise ValueError("<kernel>: <what>") unless cond. `what` is a string
    or, so that a message is only formatted when it is raised, a function
    returning one: a wrapper checks its inputs on every call."""
    if not cond:
        raise ValueError(f"{kernel}: {what() if callable(what) else what}")


def require_device(t, kernel: str) -> None:
    """Raise ValueError("<kernel>: unsupported device ...") unless `t` lies on
    the CPU (the plain version) or on CUDA (the kernel): a wrapper checks this
    before its op, which would answer a meta tensor from its fake
    implementation."""
    require(t.device.type in ("cpu", "cuda"), kernel,
            lambda: f"unsupported device {t.device}")
