"""ctypes bindings for the native C++ runtime components (tpuray/native).

The reference's host runtime is C (opencl_wrap.c, cpu_obj.c, cpu_ray.c);
the compute path here is jax/XLA, but the IO-side runtime — PNG codec and
scene-archive codec — has optional native C++ equivalents, built as a
shared library by ``make -C tpuray/native``.  This module loads it if
present and exposes a feature check; the pure-Python codecs (tpuray.io,
tpuray.sceneio) need no build step.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "native", "libtpuray.so")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_LIB_PATH):
        # NOT sticky: the library may be built later in the same process
        # (e.g. tests' `make -C tpuray/native` fixture runs after earlier
        # tests already probed and fell back to the Python codecs)
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tpuray_write_png.restype = ctypes.c_int
        lib.tpuray_write_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int]
        lib.tpuray_read_png_size.restype = ctypes.c_int
        lib.tpuray_read_png_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.tpuray_read_png.restype = ctypes.c_int
        lib.tpuray_read_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.tpuray_scene_counts.restype = ctypes.c_int
        lib.tpuray_scene_counts.argtypes = [ctypes.c_char_p] + \
            [ctypes.POINTER(ctypes.c_int)] * 4
        lib.tpuray_scene_read.restype = ctypes.c_int
        lib.tpuray_scene_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tpuray_scene_write.restype = ctypes.c_int
        lib.tpuray_scene_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def write_png(path: str, img_u8: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img_u8, np.uint8)
    h, w = img.shape[0], img.shape[1]
    rc = lib.tpuray_write_png(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h)
    if rc != 1:
        raise IOError(f"native png write failed for {path}")


def read_png(path: str) -> np.ndarray:
    lib = _load()
    assert lib is not None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tpuray_read_png_size(path.encode(), ctypes.byref(w),
                                ctypes.byref(h)) != 1:
        raise IOError(f"native png open failed for {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tpuray_read_png(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))) != 1:
        raise IOError(f"native png read failed for {path}")
    return out


# ---------------------------------------------------------------------------
# Scene archive codec (numpy structured dtypes mirror the on-disk C structs;
# layout verified in SURVEY.md §2 / tpuray/sceneio.py)
# ---------------------------------------------------------------------------

MATERIAL_DTYPE = np.dtype({
    "names": ["rgb", "ambient", "diffuse", "specular", "shininess",
              "transperent", "dielectric", "n", "reflectivity", "texture_id",
              "texture_scale"],
    "formats": [("<f4", (3,)), "<f4", "<f4", "<f4", "<u4", "<u4", "<u4",
                "<f4", "<f4", "<i4", "<f4"],
    "offsets": [0, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52],
    "itemsize": 64,
})
SPHERE_DTYPE = np.dtype({
    "names": ["origin", "radius", "mat"],
    "formats": [("<f4", (3,)), "<f4", MATERIAL_DTYPE],
    "offsets": [0, 16, 32], "itemsize": 96,
})
PLANE_DTYPE = np.dtype({
    "names": ["normal", "point", "mat"],
    "formats": [("<f4", (3,)), ("<f4", (3,)), MATERIAL_DTYPE],
    "offsets": [0, 16, 32], "itemsize": 96,
})
LIGHT_DTYPE = np.dtype({
    "names": ["origin", "radius", "intensity", "rgb"],
    "formats": [("<f4", (3,)), "<f4", "<f4", ("<f4", (3,))],
    "offsets": [0, 16, 20, 32], "itemsize": 48,
})
TRIANGLE_DTYPE = np.dtype({
    "names": ["v0", "v1", "v2", "mat"],
    "formats": [("<f4", (3,)), ("<f4", (3,)), ("<f4", (3,)), MATERIAL_DTYPE],
    "offsets": [0, 16, 32, 48], "itemsize": 112,
})


def scene_read(path: str):
    """extract_robj equivalent: returns structured arrays
    (spheres, planes, lights, triangles)."""
    lib = _load()
    assert lib is not None
    counts = [ctypes.c_int() for _ in range(4)]
    if lib.tpuray_scene_counts(path.encode(),
                               *[ctypes.byref(c) for c in counts]) != 1:
        raise IOError(f"native scene parse failed for {path}")
    ns, npl, nl, nt = (c.value for c in counts)
    spheres = np.zeros(ns, SPHERE_DTYPE)
    planes = np.zeros(npl, PLANE_DTYPE)
    lights = np.zeros(nl, LIGHT_DTYPE)
    tris = np.zeros(nt, TRIANGLE_DTYPE)
    if lib.tpuray_scene_read(path.encode(), spheres.ctypes.data,
                             planes.ctypes.data, lights.ctypes.data,
                             tris.ctypes.data) != 1:
        raise IOError(f"native scene read failed for {path}")
    return spheres, planes, lights, tris


def scene_write(path: str, spheres: np.ndarray, planes: np.ndarray,
                lights: np.ndarray, tris: np.ndarray) -> None:
    """dump_robj equivalent (padding zeroed, unlike the reference)."""
    lib = _load()
    assert lib is not None
    spheres = np.ascontiguousarray(spheres, SPHERE_DTYPE)
    planes = np.ascontiguousarray(planes, PLANE_DTYPE)
    lights = np.ascontiguousarray(lights, LIGHT_DTYPE)
    tris = np.ascontiguousarray(tris, TRIANGLE_DTYPE)
    if lib.tpuray_scene_write(path.encode(), spheres.ctypes.data,
                              len(spheres), planes.ctypes.data, len(planes),
                              lights.ctypes.data, len(lights),
                              tris.ctypes.data, len(tris)) != 1:
        raise IOError(f"native scene write failed for {path}")
