"""The native PNG encoder (port of splice_tpu/native/__init__.py).

csrc/pngio.cpp is built with g++ and zlib at first use into
splice_tpu_torch/_build (git-ignored), keyed by a hash of the source, and
loaded with ctypes. It is host IO, not a device kernel: where g++ or zlib
is missing, encode_png_rgb8 returns None and the caller writes with PIL,
as the reference does. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from splice_tpu_torch.ops._build import BUILD_DIR, CSRC_DIR

SRC = CSRC_DIR / "pngio.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target():
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()
    return BUILD_DIR / f"libpngio-{digest[:16]}.so"


def _build(out) -> bool:
    """g++ into a per-process temp name, then os.replace into place: two
    processes (a relaunched run, a concurrent one) never load a
    half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SRC), "-lz",
                        "-o", str(tmp)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded encoder, built if needed; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.png_encode_rgb8.restype = ctypes.c_int
        lib.png_encode_rgb8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t]
        lib.png_max_size.restype = ctypes.c_size_t
        lib.png_max_size.argtypes = [ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def encoder() -> str:
    """Which encoder writes the PNGs: "native (zlib)" or "PIL"."""
    return "native (zlib)" if get_lib() is not None else "PIL"


def encode_png_rgb8(arr: np.ndarray, compress_level: int = 6
                    ) -> Optional[bytes]:
    """uint8 [H, W, 3] -> PNG bytes; None where the native encoder is
    unavailable or the array is not RGB8 (the caller falls back to PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        return None
    h, w = a.shape[:2]
    cap = lib.png_max_size(h, w)
    out = ctypes.create_string_buffer(cap)
    n = lib.png_encode_rgb8(a.ctypes.data, h, w, a.strides[0],
                            compress_level, out, cap)
    if n <= 0:
        return None
    return out.raw[:n]
