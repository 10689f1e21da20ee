"""ctypes binding for the native C++ BVH builder (native/bvh_builder.cpp).

The port's own copy of `rayfinder_tpu.bvh.native`. The Python builder
(build.py) is the semantic reference; the native builder produces identical
topology and is ~50-100x faster, which matters for Sponza-scale scenes (262K
triangles). The shared library is compiled on first use with g++ -O3
-ffp-contract=off (the contract flag keeps float rounding identical to numpy
-- no FMA contraction) into `rayfinder_tpu_torch/_build/`, named after a hash
of the source and the flags; a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from .build import Bvh

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "native" / "bvh_builder.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libbvh_builder_{digest}.so"


def _compile(target: pathlib.Path) -> None:
    """Build into a directory of this process's own, then move the library
    into place: processes that build at once do not share a file."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp_dir:
        tmp = pathlib.Path(tmp_dir) / target.name
        done = subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SOURCE.name} ({done.returncode}):\n"
                               f"{done.stdout}{done.stderr}")
        tmp.replace(target)


_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        lib.rf_build_bvh.restype = ctypes.c_int64
        lib.rf_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def build_bvh_native(triangles: np.ndarray) -> Bvh:
    """Build a BVH with the native builder. Same contract as build.build_bvh."""
    lib = _load()
    triangles = np.ascontiguousarray(triangles, dtype=np.float32)
    num_tris = triangles.shape[0]
    cap = 2 * num_tris

    aabb_min = np.empty((cap, 3), np.float32)
    aabb_max = np.empty((cap, 3), np.float32)
    tri_offset = np.empty(cap, np.uint32)
    second_child = np.empty(cap, np.uint32)
    tri_count = np.empty(cap, np.uint32)
    split_axis = np.empty(cap, np.uint32)
    triangle_indices = np.empty(num_tris, np.int64)

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    n = lib.rf_build_bvh(
        ptr(triangles, ctypes.c_float),
        num_tris,
        ptr(aabb_min, ctypes.c_float),
        ptr(aabb_max, ctypes.c_float),
        ptr(tri_offset, ctypes.c_uint32),
        ptr(second_child, ctypes.c_uint32),
        ptr(tri_count, ctypes.c_uint32),
        ptr(split_axis, ctypes.c_uint32),
        ptr(triangle_indices, ctypes.c_int64),
    )
    if n < 0:
        raise RuntimeError("rf_build_bvh failed (bad input or capacity overflow)")

    return Bvh(
        aabb_min=aabb_min[:n].copy(),
        aabb_max=aabb_max[:n].copy(),
        triangles_offset=tri_offset[:n].copy(),
        second_child_offset=second_child[:n].copy(),
        triangle_count=tri_count[:n].copy(),
        split_axis=split_axis[:n].copy(),
        triangle_indices=triangle_indices,
    )


def build_bvh_fast(triangles: np.ndarray) -> Bvh:
    """The native builder (the same BVH as build.build_bvh, faster)."""
    return build_bvh_native(triangles)
