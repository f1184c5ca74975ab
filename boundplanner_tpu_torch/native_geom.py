"""ctypes binding of the repository's native geometry core
(``native/geom.cpp``): polytope vertex enumeration and redundant-row
removal in 3D, the host-side set helpers of the planner.

The port's own binding: ``g++`` compiles the source at first use into the
port's build directory ``boundplanner_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, so a changed source
rebuilds. Building and loading hold a lock, so concurrent planner threads
build once; the compile goes to a temporary name and is renamed into
place, so concurrent processes never load a partial file. Without a
compiler ``available()`` is False and ``utils.sets`` takes its numpy
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "geom.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbp_geom_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SRC):
            return None
        path = library_path()
        if not os.path.exists(path) and not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.bp_polytope_vertices.restype = ctypes.c_int
        lib.bp_polytope_vertices.argtypes = [dp, dp, ctypes.c_int, ctypes.c_double,
                                             dp, ctypes.c_int]
        lib.bp_reduce_ineqs.restype = ctypes.c_int
        lib.bp_reduce_ineqs.argtypes = [dp, dp, ctypes.c_int, ctypes.c_double,
                                        ctypes.c_double, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_c(arr):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def polytope_vertices(a_set, b_set, tol: float = 1e-7) -> np.ndarray:
    """Vertices (k, 3) of {x : A x <= b}."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native geom core unavailable")
    _, a_p = _as_c(np.asarray(a_set).reshape(-1, 3))
    b, b_p = _as_c(np.asarray(b_set).reshape(-1))
    cap = 2048
    out = np.empty((cap, 3), dtype=np.float64)
    n = lib.bp_polytope_vertices(
        a_p, b_p, b.shape[0], tol, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap
    )
    if n < 0:
        raise RuntimeError("vertex buffer overflow")
    return out[:n].copy()


def reduce_ineqs(a_set, b_set) -> Tuple[np.ndarray, np.ndarray]:
    """The rows of {A x <= b} that are active at some vertex."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native geom core unavailable")
    a, a_p = _as_c(np.asarray(a_set).reshape(-1, 3))
    b, b_p = _as_c(np.asarray(b_set).reshape(-1))
    m = b.shape[0]
    keep = np.zeros(m, dtype=np.uint8)
    n = lib.bp_reduce_ineqs(
        a_p, b_p, m, 1e-7, 1e-6, keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    if n < 0:
        raise RuntimeError("vertex buffer overflow")
    mask = keep.astype(bool)
    return a[mask].copy(), b[mask].copy()
