"""Native PNG decode for the port's host data loaders.

The port's own copy of dcl_net_tpu/data/png.py. The C++ decoder
(``dcl_net_tpu_torch/csrc/host/png_decoder.cpp`` and ``inflate.cpp``) does
one inflate over the IDAT chunks and writes straight into a numpy buffer;
the ctypes call releases the GIL, so the loaders' thread pools scale. Its
output is ``np.array(PIL.Image.open(path))`` bit for bit for every format
the datasets hold (8/16-bit gray, RGB, RGBA, gray+alpha, 8-bit palette ->
indices).

The library is built with a C++ compiler (``$CXX``, else ``g++``) at first
use, into ``dcl_net_tpu_torch/build/`` under a name that hashes the
sources and flags, and links zlib. It is the one PNG path: where it cannot
be built or loaded, ``imread`` raises with the compiler's output; it never
falls back to PIL for a PNG the decoder handles. PIL, imported only when
needed, decodes just the variants the decoder reports as unsupported
(interlaced, bit depths 1/2/4).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from dcl_net_tpu_torch import host_build

BUILD_DIR = host_build.BUILD_DIR
SOURCES = ("png_decoder.cpp", "inflate.cpp")
STEM = "libdclx_host"
UNSUPPORTED = -2  # the decoder's code for a PNG variant it does not handle


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    return host_build.library_path(SOURCES, STEM, build_dir)


def build(cxx: str = None, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the host library if the one for these sources is missing and
    return its path (host_build.build). Raises RuntimeError with the
    compiler's output when the compiler is missing or fails (zlib's headers
    or library absent, say)."""
    return host_build.build(SOURCES, STEM, "the PNG host library", libs=("-lz",),
                            cxx=cxx, build_dir=build_dir)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.dclx_png_probe.restype = ctypes.c_int
    lib.dclx_png_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.dclx_png_decode.restype = ctypes.c_int
    lib.dclx_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
    return lib


def _pil_imread(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.array(Image.open(io.BytesIO(data)))


def imread(path: str) -> np.ndarray:
    """Decode a PNG file to a numpy array (PIL's array conventions).

    gray -> [H, W] u8/u16; palette -> [H, W] u8 indices; RGB/RGBA/LA ->
    [H, W, C]. Raises ValueError for a file the decoder rejects as not a
    PNG or as malformed."""
    with open(path, "rb") as f:
        data = f.read()
    lib = library()
    w, h, ch, bpc = (ctypes.c_int() for _ in range(4))
    rc = lib.dclx_png_probe(data, len(data), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(ch), ctypes.byref(bpc))
    if rc == UNSUPPORTED:
        return _pil_imread(data)
    if rc != 0:
        raise ValueError(f"{path}: not a PNG the decoder reads (code {rc})")
    dtype = np.uint16 if bpc.value == 2 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    out = np.empty(shape, dtype)
    rc = lib.dclx_png_decode(data, len(data), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"{path}: PNG decode failed (code {rc})")
    return out
