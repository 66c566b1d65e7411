"""ctypes bindings for the native runtime library (native/lfs_native.cpp).

Builds on first use (g++ is in the image; no pybind11, plain C ABI). Every
entry point has a pure-Python fallback so the package works without a
toolchain — but the native paths are the ones sized for production data
(COLMAP points3D.bin at millions of records, PLY deinterleave, image
downsampling)."""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "liblfs_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(
                ["sh", str(_NATIVE_DIR / "build.sh")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.colmap_points3d_count.restype = ctypes.c_int64
        lib.colmap_points3d_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.colmap_points3d_parse.restype = ctypes.c_int64
        lib.colmap_points3d_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.ply_deinterleave.restype = None
        lib.ply_deinterleave.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.resize_box_rgb.restype = None
        lib.resize_box_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_points3d_bin(data: bytes) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Fast path for COLMAP points3D.bin. Returns (means [N,3], colors [N,3])
    or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = lib.colmap_points3d_count(data, len(data))
    if n < 0:
        return None
    means = np.empty((n, 3), np.float32)
    colors = np.empty((n, 3), np.float32)
    got = lib.colmap_points3d_parse(
        data, len(data),
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got != n:
        return None
    return means, colors


def deinterleave(blob: np.ndarray, n: int, stride: int, sel: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob, np.float32)
    sel = np.ascontiguousarray(sel, np.int32)
    out = np.empty((len(sel), n), np.float32)
    lib.ply_deinterleave(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, stride,
        sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(sel),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def resize_box(img: np.ndarray, factor: int) -> Optional[np.ndarray]:
    """Integer-factor box downsample of [H, W, 3] float RGB."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    h, w, _ = img.shape
    out = np.empty((h // factor, w // factor, 3), np.float32)
    lib.resize_box_rgb(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, factor,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
