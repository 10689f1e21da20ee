"""Build and bind the CUDA kernels of `csrc/`.

The kernels are compiled at first use with nvcc for Hopper (sm_90a), one
nvcc per source, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes. Processes that need the
library at once build it one at a time under a file lock in the build
directory, so the first builds it and the others load it. The library is
named after a hash of the sources and the flags, under
`rayfinder_tpu_torch/_build/`, and is rebuilt when either changes. Only the
repository's own sources go in.

`--fmad=false` keeps nvcc from contracting a*b+c into an FMA, which would
change the rounding of the intersection tests; without fast-math flags,
division and sqrt are IEEE-rounded. Together they make the kernels agree
bit for bit with the plain torch versions on t, tri and occlusion.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from ..render.scene import WALK_STACK

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("walk.cu", "regen.cu", "regen_shaded.cu", "regen_segs.cu", "slab_entry.cu",
           "skyround.cu", "deferred.cu")
HEADERS = ("traverse.cuh", "traverse2.cuh", "path.cuh", "shade.cuh")
# Flags of each source's compile; the objects are then linked with -shared.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# Scene arguments of the entry points that walk the BVH (K1-K6, K8): the
# root's rows of aabb_min, aabb_max, tri_offset, tri_count, then the packed
# walk tables bvh_nodes2 and tri_pos4, the triangle count.
_PACKED_ARGTYPES = [_P] * 6 + [_I]
# ... and of the in-kernel shade: triangle attributes, texture descriptors,
# texels.
_SHADE_ARGTYPES = [_P] * 3
_ARGTYPES = {
    # ..., the walk's stack, origin, direction, t_max, n, t, tri, visits, stream
    "rf_intersect_closest": _PACKED_ARGTYPES + [_I] + [_P, _P, _P, _I, _P, _P, _P, _P],
    # ..., the walk's stack, origin, direction, t_max, n, occ, stream
    "rf_intersect_any": _PACKED_ARGTYPES + [_I] + [_P, _P, _P, _I, _P, _P],
    # ..., params, n, 14 lane inputs, 9 outputs, stream
    "rf_trace_regen": _PACKED_ARGTYPES + [_P, _I] + [_P] * 23 + [_P],
    # ..., the walk's stack, shade tables, params, n, 14 lane inputs, 11
    # outputs, the samples' radiance scratch and the item counter (both null
    # above floor 0), the ray counts, stream
    "rf_trace_regen_shaded": (_PACKED_ARGTYPES + [_I] + _SHADE_ARGTYPES + [_P, _I] + [_P] * 25
                              + [_P, _P] + [_P] + [_P]),
    # ..., params, n, segs, 3 pixel + 6 slot inputs, 6 outputs, stream
    "rf_trace_regen_segs": _PACKED_ARGTYPES + [_P, _I, _I] + [_P] * 15 + [_P],
    # ..., origin, direction, t_max, n, t, tri, counts, stream
    "rf_intersect_closest_counted": _PACKED_ARGTYPES + [_P, _P, _P, _I, _P, _P, _P, _P],
    # box_min, box_max, weight, m, group, origin, inv_dir, bound, n, need,
    # group_min (or null), first_group, stream
    "rf_slab_entry_reduce": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    # ..., params, n, rounds, mode, u, v_tex, noise_base, acc, stream
    "rf_sky_round": _PACKED_ARGTYPES + [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    # The deferred passes (csrc/deferred.cu): params, n, then the planes each
    # reads and writes, stream; shade tables first where a pass shades.
    # origin, direction
    "rf_deferred_rays": [_P, _I, _P, _P, _P],
    # direction, t, tri -> hit, position, normal, albedo, depth
    "rf_deferred_gbuffer": _SHADE_ARGTYPES + [_P, _I] + [_P] * 8 + [_P],
    # tile, position, normal -> origin, light, bounce
    "rf_deferred_light_rays": [_P, _I] + [_P] * 6 + [_P],
    # hit, origin, wi, light, tri -> b_origin, b_light
    "rf_deferred_bounce": _SHADE_ARGTYPES + [_P, _I] + [_P] * 7 + [_P],
    # hit, view_dir, normal, albedo, light, occluded, tri, b_occluded,
    # b_light -> sample
    "rf_deferred_sample": [_P, _I] + [_P] * 10 + [_P],
    # sample, accum -> blended, display
    "rf_deferred_resolve": [_P, _I] + [_P] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librayfinder_kernels_{_digest()}.so"


def build_log_path() -> pathlib.Path:
    """nvcc's output (-Xptxas -v: registers, spills) of the current build."""
    return library_path().with_suffix(".log")


def _compile(target: pathlib.Path) -> None:
    """Compile every source at once (one nvcc each), then link them."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = pathlib.Path(tmp_dir)
        objects = [tmp / f"{pathlib.Path(s).stem}.o" for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / s)]
                for s, obj in zip(SOURCES, objects)]
        logs = [obj.with_suffix(".log") for obj in objects]
        procs = []
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT))
        results = [(cmd, proc.wait(), log.read_text())
                   for cmd, proc, log in zip(cmds, procs, logs)]
        if all(rc == 0 for _, rc, _ in results):
            link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-o", str(tmp / "lib.so"), *map(str, objects)]
            done = subprocess.run(link, capture_output=True, text=True)
            results.append((link, done.returncode, done.stdout + done.stderr))
        target.with_suffix(".log").write_text(
            "".join(" ".join(cmd) + "\n" + out for cmd, _, out in results))
        failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
        os.replace(tmp / "lib.so", target)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                # Processes that start together (the ranks of a sharded
                # render) build one after another: the first builds, the
                # others find the library when the lock is theirs.
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(BUILD_DIR / "build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not path.exists():
                        _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype and shape on
    `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _pointers(scene, device, tables) -> list:
    """The data pointers of the scene's tensors named in `tables` ((name,
    dtype, shape) each), after checking them."""
    args = []
    for name, dtype, shape in tables:
        tensor = getattr(scene, name)
        check(tensor, f"scene.{name}", dtype, shape, device)
        args.append(tensor.data_ptr())
    return args


def packed_args(scene, device, sized: bool = False) -> list:
    """The pointer and triangle-count arguments of the packed walk
    (csrc/traverse2.cuh), after checking its tables: the SoA planes that
    hold the root's box and leaf range, and the packed tables, which the
    kernel reads with 16-byte loads. With `sized`, the entries of the
    scene's walk stack follow (render/scene.py walk_stack): the kernels that
    come with a walk of each size (K1, K2, K4) take it. The others walk
    WALK_STACK entries, and raise for a scene whose tree needs more."""
    if not sized and scene.walk_stack != WALK_STACK:
        raise ValueError(
            f"the scene's tree needs a walk of {scene.walk_stack} stack entries, which only "
            f"K1, K2 and K4 (the default route, the ray queries, the deferred renderer) have")
    n, t = scene.num_nodes, scene.num_triangles
    args = _pointers(scene, device, (
        ("bvh_aabb_min", torch.float32, (n, 3)),
        ("bvh_aabb_max", torch.float32, (n, 3)),
        ("bvh_tri_offset", torch.int32, (n,)),
        ("bvh_tri_count", torch.int32, (n,)),
        ("bvh_nodes2", torch.int32, ((n - 1) // 2, 16)),
        ("tri_pos4", torch.float32, (t, 12)),
    ))
    for name in ("bvh_nodes2", "tri_pos4"):
        if getattr(scene, name).data_ptr() % 16:
            raise ValueError(f"scene.{name}: not 16-byte aligned")
    return args + [t, scene.walk_stack] if sized else args + [t]


def shade_args(scene, device) -> list:
    """The pointers of the scene's shading tables (triangle attributes,
    texture descriptors, texels), after checking them."""
    return _pointers(scene, device, (
        ("tri_attrs", torch.float32, (scene.num_triangles, 25)),
        ("tex_desc", torch.int32, (scene.tex_desc.shape[0], 3)),
        ("texels", torch.int32, (scene.texels.shape[0],)),
    ))


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
