"""ctypes bindings to the native C++ host library (native/potato_native.cpp).

Fast paths for OBJ parsing, TGA decode/encode and the Morton order of a
point set. Loading is lazy and
optional: if `native/libpotato_native.so` is missing, the first call tries
`make -C native`; if there is still no library, every function here
returns None and the callers take their numpy paths, which stay the
behavioural oracle in tests either way. This is host code: nothing here
touches a device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libpotato_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("num_vertices", ctypes.c_int64),
        ("num_triangles", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built with `make -C native` on first use if it
    is missing), or None when it cannot be built or loaded."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(LIB_PATH):
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.obj_parse.restype = ctypes.POINTER(_ObjResult)
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
    lib.tga_dims.restype = ctypes.c_int32
    lib.tga_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_int32)]
    lib.tga_decode.restype = ctypes.c_int32
    lib.tga_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_void_p]
    lib.tga_encode.restype = None
    lib.tga_encode.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_void_p]
    lib.morton_argsort.restype = None
    lib.morton_argsort.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
    _lib = lib
    return _lib


def _copy(ptr, shape, dtype):
    if shape[0] == 0:
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape).copy()


def obj_parse(text: str):
    """Native OBJ parse -> (positions, normals, uvs, indices) or None.

    Raises ValueError on non-triangular faces, as the numpy loader does.
    """
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode()
    res = lib.obj_parse(raw, len(raw))
    try:
        r = res.contents
        if r.error == 1:
            raise ValueError("Non-triangular faces are not supported")
        nv, nt = r.num_vertices, r.num_triangles
        return (_copy(r.positions, (nv, 3), np.float32),
                _copy(r.normals, (nv, 3), np.float32),
                _copy(r.uvs, (nv, 2), np.float32),
                _copy(r.indices, (nt, 3), np.int32))
    finally:
        lib.obj_free(res)


def tga_decode(data: bytes) -> Optional[np.ndarray]:
    """(H, W, 4) uint8 RGBA, or None (no library, or a header it does not
    take: the numpy path then raises its error)."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    if lib.tga_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.tga_decode(data, len(data), out.ctypes.data)
    return out if rc == 0 else None


def tga_encode(rgba: np.ndarray) -> Optional[bytes]:
    """32-bpp BGRA TGA bytes of (H, W, 4) uint8 RGBA, or None."""
    lib = get_lib()
    if lib is None:
        return None
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {rgba.shape}")
    h, w = rgba.shape[:2]
    out = np.empty(18 + w * h * 4, np.uint8)
    lib.tga_encode(rgba.ctypes.data, w, h, out.ctypes.data)
    return out.tobytes()


def morton_argsort(points: np.ndarray) -> Optional[np.ndarray]:
    """(n,) uint32 order of the (n, 3) points along 30-bit Morton codes over
    their bounding box (a stable sort: equal codes keep their order), or
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (n, 3) points, got {pts.shape}")
    order = np.empty(pts.shape[0], np.uint32)
    lib.morton_argsort(pts.ctypes.data, pts.shape[0], order.ctypes.data)
    return order
