"""ctypes bindings of the native C++ host runtime (port of
``cpu_based_ray_tracer_tpu.utils.native``; the source is the port's own
``csrc/native.cpp``).

The reference's BVH builder and OBJ loader are C++; so are these, as
host-side scene preprocessing, not device work.  At first use the library
is compiled with ``g++`` into ``build/native/`` at the root of the
checkout, under a name that carries a hash of the source and the flags,
and loaded with ``ctypes``.  Every entry point returns None where the
library is unavailable (no compiler, a failed build): its numpy twin
(``ops.bvh.build_bvh``, ``utils.objio.load_obj``) has the same contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
_lock = threading.Lock()
_lib = None
_tried = False


def _target() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcrt_native.{h.hexdigest()[:12]}.so")


def _build(out: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"      # renamed into place when built
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def _load():
    """Load (building if necessary) the native library; None if
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _target()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        f64, f32, i32 = (ctypes.POINTER(t) for t in (
            ctypes.c_double, ctypes.c_float, ctypes.c_int32))
        i64 = ctypes.c_int64
        lib.crt_build_bvh.argtypes = [f64, i64, i64, f32, f32, i32, i32, i32,
                                      i32]
        lib.crt_obj_count.argtypes = [ctypes.c_char_p]
        lib.crt_obj_load.argtypes = [ctypes.c_char_p, f64, f64, i32]
        for fn in (lib.crt_build_bvh, lib.crt_obj_count, lib.crt_obj_load):
            fn.restype = i64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(tri_vertices: np.ndarray, leaf_size: int = 4):
    """Native flattened-BVH build -> ``ops.bvh.FlatBVH``, or None when the
    library is unavailable.  The contract of ``ops.bvh.build_bvh``."""
    lib = _load()
    if lib is None:
        return None
    from cpu_based_ray_tracer_tpu_torch.ops.bvh import FlatBVH

    verts = np.ascontiguousarray(
        np.asarray(tri_vertices, np.float64).reshape(-1, 9))
    n = len(verts)
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_skip = np.empty(cap, np.int32)
    leaf_first = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)
    c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    m = lib.crt_build_bvh(
        c(verts, ctypes.c_double), n, int(leaf_size),
        c(node_min, ctypes.c_float), c(node_max, ctypes.c_float),
        c(node_skip, ctypes.c_int32), c(leaf_first, ctypes.c_int32),
        c(leaf_count, ctypes.c_int32), c(order, ctypes.c_int32))
    if m <= 0:
        return None
    return FlatBVH(node_min=node_min[:m], node_max=node_max[:m],
                   node_skip=node_skip[:m], leaf_first=leaf_first[:m],
                   leaf_count=leaf_count[:m], order=order,
                   max_leaf=leaf_size)


def load_obj_native(path: str):
    """Native OBJ parse -> (tris (T,3,3) f64, uv (T,3,2) f64 or None), or
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = lib.crt_obj_count(str(path).encode())
    if n < 0:
        raise FileNotFoundError(path)
    tris = np.empty((max(n, 1), 3, 3), np.float64)
    uv = np.empty((max(n, 1), 3, 2), np.float64)
    has_uv = ctypes.c_int32(0)
    got = lib.crt_obj_load(
        str(path).encode(),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(has_uv))
    if got != n:
        raise RuntimeError(f"native OBJ loader read {got} of {n} triangles")
    return tris[:n], (uv[:n] if has_uv.value else None)
