"""The port's JPEG decoder: ``decode_jpeg.cpp`` built with ``g++`` against the
system libjpeg at first use and called through ``ctypes``.

It decodes at full scale to RGB, the way ``cv2.imdecode(buf,
IMREAD_COLOR)`` followed by a BGR-to-RGB swap does (the EXIF orientation
is applied by the caller, ``data.base.decode_rgb``).  The JAX package's
``viddet_tpu/native/decode.cpp`` prescales in the DCT domain and so does
not equal OpenCV; this copy of its JPEG half leaves the scale alone.

The library is built into ``build/viddet_tpu_torch/native/<hash>/`` at the
repository root (``build/`` is git-ignored), keyed by a hash of the source
and the flags, the way ``kernels/build.py`` keys the CUDA kernels.  Nothing
is built at import time.  A failed build raises with the compiler's
output; there is no other decoder to fall back to.  ``ctypes`` releases
the GIL for the call, so the loader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decode_jpeg.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "viddet_tpu_torch" / "native"
LIB_NAME = "libviddet_jpeg.so"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg"]
_ERR_LEN = 512

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(repr((FLAGS, LIBS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has none yet."""
    lib_path = BUILD_ROOT / _digest() / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        staged = Path(tmp) / LIB_NAME
        cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(staged), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"JPEG decoder build failed:\n$ {' '.join(cmd)}\n{proc.stderr}")
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        os.replace(staged, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded decoder (built on first call), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulong
            lib.vd_jpeg_header.argtypes = [p, size, ctypes.POINTER(i), ctypes.POINTER(i), p, i]
            lib.vd_jpeg_decode.argtypes = [p, size, p, i, i, p, i]
            lib.vd_jpeg_header.restype = lib.vd_jpeg_decode.restype = i
            _lib = lib
        return _lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB at full scale, the raster as stored
    (no EXIF orientation).  ``name`` (a path, a record) goes into the
    messages.  Raises ValueError for bytes that are not a JPEG (a PNG, say)
    and for a JPEG that libjpeg cannot decode whole."""
    if data[:3] != b"\xff\xd8\xff":  # SOI, then a marker
        raise ValueError(f"{name}: not a JPEG (the port's decoder reads JPEG only)")
    lib = library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vd_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN):
        raise ValueError(f"{name}: JPEG header: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.vd_jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value, err, _ERR_LEN):
        raise ValueError(f"{name}: JPEG decode: {err.value.decode(errors='replace')}")
    return out
