"""ctypes bindings to the native host runtime (native/libtutuhost.so).

The reference's host layer is all C++ (OBJ loader OBJ_Loader.h, BVH build
BVH.hpp:47-123, PPM I/O PPMGenerator.hpp); this module binds the native
equivalents and falls back to the pure Python implementations when the
library cannot be built. The library is built from native/host.cpp with
the in-repo Makefile on first use (no network, no pip).
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtutuhost.so")

_lib = None
_tried = False


class _ObjResult(ct.Structure):
    _fields_ = [("verts", ct.POINTER(ct.c_float)),
                ("normals", ct.POINTER(ct.c_float)),
                ("uvs", ct.POINTER(ct.c_float)),
                ("n_tris", ct.c_int64),
                ("ok", ct.c_int32)]


class _BvhResult(ct.Structure):
    _fields_ = [("bb_min", ct.POINTER(ct.c_float)),
                ("bb_max", ct.POINTER(ct.c_float)),
                ("left", ct.POINTER(ct.c_int32)),
                ("right", ct.POINTER(ct.c_int32)),
                ("start", ct.POINTER(ct.c_int32)),
                ("count", ct.POINTER(ct.c_int32)),
                ("prim", ct.POINTER(ct.c_int32)),
                ("n_nodes", ct.c_int64),
                ("n_prims", ct.c_int64)]


class _PpmResult(ct.Structure):
    _fields_ = [("rgb", ct.POINTER(ct.c_float)),
                ("w", ct.c_int32), ("h", ct.c_int32), ("ok", ct.c_int32)]


def _build() -> bool:
    """Compile native/host.cpp to a temporary name and rename it into
    place, so concurrent processes never load a half-written library.
    Prints why when the build fails."""
    tmp = f"{_LIB_PATH}.tmp{os.getpid()}"
    try:
        subprocess.run(["make", "-s", "-C", _NATIVE_DIR, "-B",
                        f"OUT={os.path.basename(tmp)}"],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        print(f"tuturenderer_tpu: native library build failed, using the "
              f"pure-Python fallbacks: {detail.strip()}", file=sys.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ct.CDLL]:
    """Load (building if missing or older than host.cpp) the native
    library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = os.path.join(_NATIVE_DIR, "host.cpp")
    stale = not os.path.exists(_LIB_PATH) or \
        os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)
    if stale and not _build():
        return None
    try:
        lib = ct.CDLL(_LIB_PATH)
    except OSError as e:
        print(f"tuturenderer_tpu: cannot load {_LIB_PATH}, using the "
              f"pure-Python fallbacks: {e}", file=sys.stderr)
        return None
    lib.tutu_obj_load.restype = ct.POINTER(_ObjResult)
    lib.tutu_obj_load.argtypes = [ct.c_char_p]
    lib.tutu_obj_result_free.argtypes = [ct.POINTER(_ObjResult)]
    lib.tutu_bvh_build.restype = ct.POINTER(_BvhResult)
    lib.tutu_bvh_build.argtypes = [ct.POINTER(ct.c_float), ct.c_int64,
                                   ct.c_int32]
    lib.tutu_bvh_free.argtypes = [ct.POINTER(_BvhResult)]
    lib.tutu_ppm_write.restype = ct.c_int32
    lib.tutu_ppm_write.argtypes = [ct.c_char_p, ct.POINTER(ct.c_float),
                                   ct.c_int32, ct.c_int32, ct.c_float]
    lib.tutu_ppm_read.restype = ct.POINTER(_PpmResult)
    lib.tutu_ppm_read.argtypes = [ct.c_char_p]
    lib.tutu_ppm_free.argtypes = [ct.POINTER(_PpmResult)]
    _lib = lib
    return lib


def _as_np(ptr, count, dtype):
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def obj_load(path: str):
    """-> (verts [n,3,3], normals [n,3,3], uvs [n,3,2]) or None if the
    native path is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    res = lib.tutu_obj_load(path.encode())
    try:
        r = res.contents
        if not r.ok:
            raise FileNotFoundError(path)
        n = r.n_tris
        verts = _as_np(r.verts, n * 9, np.float32).reshape(n, 3, 3)
        normals = _as_np(r.normals, n * 9, np.float32).reshape(n, 3, 3)
        uvs = _as_np(r.uvs, n * 6, np.float32).reshape(n, 3, 2)
        return verts, normals, uvs
    finally:
        lib.tutu_obj_result_free(res)


def bvh_build(verts: np.ndarray, leaf_size: int = 4):
    """-> dict of flat BVH arrays or None if unavailable. verts [n,3,3]."""
    lib = load_library()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float32)
    res = lib.tutu_bvh_build(v.ctypes.data_as(ct.POINTER(ct.c_float)),
                             v.shape[0], leaf_size)
    try:
        r = res.contents
        m = r.n_nodes
        p = r.n_prims
        return dict(
            bb_min=_as_np(r.bb_min, m * 3, np.float32).reshape(m, 3),
            bb_max=_as_np(r.bb_max, m * 3, np.float32).reshape(m, 3),
            left=_as_np(r.left, m, np.int32),
            right=_as_np(r.right, m, np.int32),
            start=_as_np(r.start, m, np.int32),
            count=_as_np(r.count, m, np.int32),
            prim=_as_np(r.prim, max(p, 1), np.int32)[:p],
        )
    finally:
        lib.tutu_bvh_free(res)


def ppm_write(path: str, rgb: np.ndarray, gamma: float = 0.78) -> bool:
    lib = load_library()
    if lib is None:
        return False
    a = np.ascontiguousarray(rgb, np.float32)
    h, w, _ = a.shape
    return bool(lib.tutu_ppm_write(path.encode(),
                                   a.ctypes.data_as(ct.POINTER(ct.c_float)),
                                   w, h, gamma))


def ppm_read(path: str):
    lib = load_library()
    if lib is None:
        return None
    res = lib.tutu_ppm_read(path.encode())
    try:
        r = res.contents
        if not r.ok:
            raise FileNotFoundError(path)
        return _as_np(r.rgb, r.w * r.h * 3, np.float32).reshape(r.h, r.w, 3)
    finally:
        lib.tutu_ppm_free(res)
