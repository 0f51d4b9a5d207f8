"""ctypes loader for the native BVH builder.

The library is built from ``bvh_builder.cpp`` on first use, into a file
named after the source's hash (so an edited source builds a new library);
no binary is kept in version control.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, f"libbvh_builder-{digest}.so")


def _compile(so: str) -> None:
    # build to a private name, then rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, so)


def load() -> Optional[ctypes.CDLL]:
    """The shared library, compiling it if needed; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            so = _library_path()
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
            argtypes = [
                ctypes.POINTER(ctypes.c_float),  # aabb_min
                ctypes.POINTER(ctypes.c_float),  # aabb_max
                ctypes.c_int64,  # n_tris
                ctypes.POINTER(ctypes.c_int32),  # node_tri
                ctypes.POINTER(ctypes.c_int32),  # node_right
                ctypes.POINTER(ctypes.c_float),  # node_min
                ctypes.POINTER(ctypes.c_float),  # node_max
                ctypes.POINTER(ctypes.c_int32),  # max_depth out
            ]
            lib.bvh_build.restype = ctypes.c_int
            lib.bvh_build.argtypes = argtypes
            lib.bvh_build_sah.restype = ctypes.c_int
            lib.bvh_build_sah.argtypes = argtypes
            _lib = lib
        except Exception:
            _failed = True
        return _lib
