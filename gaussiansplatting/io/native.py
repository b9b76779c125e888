"""ctypes bindings for the native C++ IO library (native/gs_io.cpp).

The reference's loaders are C++ (colmap_loader.cpp, tinyply); ours keep a C++
fast path for the variable-length binary walks that numpy cannot vectorize
(COLMAP points3D/images track skipping) while every caller degrades gracefully
to the pure-Python parsers when no library can be built.

The library is built from source at first use into native/build/ (listed in
.gitignore) with the host's C++ compiler, and rebuilt when the source is
newer; ``make -C native`` does the same by hand.  Hosts without a compiler
use the NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
SOURCE = os.path.join(_NATIVE_DIR, "gs_io.cpp")
LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libgsio.so")


def _build_lib() -> str | None:
    """Compile SOURCE into LIB_PATH unless an up-to-date build exists;
    returns the library path, or None when it cannot be built."""
    if os.path.exists(LIB_PATH) and (
        not os.path.exists(SOURCE)
        or os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)
    ):
        return LIB_PATH
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(SOURCE):
        return None
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    # build under a private name, then rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, SOURCE],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return LIB_PATH


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.gsio_count_points.restype = ctypes.c_longlong
        lib.gsio_count_points.argtypes = [ctypes.c_char_p]
        lib.gsio_load_points.restype = ctypes.c_longlong
        lib.gsio_load_points.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        lib.gsio_knn_mean_dist.restype = ctypes.c_int
        lib.gsio_knn_mean_dist.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def load_points_bin(path: str):
    """COLMAP points3D.bin via C++; None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.gsio_count_points(path.encode())
    if n < 0:
        return None
    pos = np.empty((n, 3), np.float32)
    col = np.empty((n, 3), np.float32)
    err = np.empty((n,), np.float32)
    got = lib.gsio_load_points(
        path.encode(),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got != n:
        return None
    return pos, col, err


def knn_mean_dist(points: np.ndarray, k: int = 3):
    """Mean k-NN distance per point via the C++ grid index; None if
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((pts.shape[0],), np.float32)
    rc = lib.gsio_knn_mean_dist(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0],
        k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None
