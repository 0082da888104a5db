"""ctypes bindings for the native CPU tracer (libvkrt_native.so).

Builds the library with make (g++, with OpenMP where the compiler has
it, single-threaded otherwise) on first use when it is missing or older
than tracer.cpp, into a temporary name that is then renamed, so
concurrent processes never load a half-written file. A failed build
raises: the golden gates must not run without their oracle. ctypes,
since pybind11 is not a dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libvkrt_native.so")

_lib = None


def _build() -> None:
    tmp = f"{_SO}.{os.getpid()}.tmp"
    logs = []
    for extra in ([], ["OMPFLAGS="]):        # OpenMP first, then without
        r = subprocess.run(["make", "-C", _DIR, "-B", f"OUT={tmp}"] + extra,
                           capture_output=True, text=True)
        logs.append(r.stdout + r.stderr)
        if r.returncode == 0:
            os.replace(tmp, _SO)
            return
    raise RuntimeError(f"building {_SO} failed:\n" + "\n".join(logs))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_DIR, "tracer.cpp")
    if (not os.path.exists(_SO)
            or os.path.getmtime(src) > os.path.getmtime(_SO)):
        _build()
    lib = ctypes.CDLL(_SO)

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.vkrt_bvh_create.restype = ctypes.c_void_p
    lib.vkrt_bvh_create.argtypes = [f32p, f32p, f32p, ctypes.c_int32]
    lib.vkrt_bvh_destroy.argtypes = [ctypes.c_void_p]
    lib.vkrt_trace_closest.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_float,
        f32p, i32p, f32p, f32p]
    lib.vkrt_trace_occluded.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_float, u8p]
    lib.vkrt_trace_closest_stable.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, i32p, f32p, f32p, u8p]
    lib.vkrt_trace_occluded_stable.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        u8p, u8p]
    _lib = lib
    return lib


class NativeBVH:
    """Native median-split BVH with closest/occlusion traversal."""

    def __init__(self, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
        lib = _load()
        self._lib = lib
        self._n = int(v0.shape[0])
        self._handle = lib.vkrt_bvh_create(
            np.ascontiguousarray(v0, np.float32),
            np.ascontiguousarray(e1, np.float32),
            np.ascontiguousarray(e2, np.float32), self._n)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vkrt_bvh_destroy(self._handle)
            self._handle = None

    def closest(self, origins, dirs, tmin, tmax):
        n = origins.shape[0]
        t = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        self._lib.vkrt_trace_closest(
            self._handle,
            np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(dirs, np.float32),
            np.ascontiguousarray(np.broadcast_to(
                np.asarray(tmax, np.float32), (n,))),
            n, np.float32(tmin), t, tri, u, v)
        return t, tri, u, v

    def occluded(self, origins, dirs, tmin, tmax):
        n = origins.shape[0]
        out = np.empty(n, np.uint8)
        self._lib.vkrt_trace_occluded(
            self._handle,
            np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(dirs, np.float32),
            np.ascontiguousarray(np.broadcast_to(
                np.asarray(tmax, np.float32), (n,))),
            n, np.float32(tmin), out)
        return out.astype(bool)

    # Stability-certified variants (golden-gate support): identical results
    # plus a per-ray `stable` flag — True iff any correct f32 tracer must
    # reproduce the answer (no acceptance boundary within the mu/mt
    # margins; see tracer.cpp "Stability classification").
    def closest_stable(self, origins, dirs, tmin, tmax,
                       mu: float = 2e-5, mt: float = 1e-5,
                       deps: float = 5e-7, oeps: float = 0.0):
        n = origins.shape[0]
        t = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        stable = np.empty(n, np.uint8)
        self._lib.vkrt_trace_closest_stable(
            self._handle,
            np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(dirs, np.float32),
            np.ascontiguousarray(np.broadcast_to(
                np.asarray(tmax, np.float32), (n,))),
            n, np.float32(tmin), np.float32(mu), np.float32(mt),
            np.float32(deps), np.float32(oeps), t, tri, u, v, stable)
        return t, tri, u, v, stable.astype(bool)

    def occluded_stable(self, origins, dirs, tmin, tmax,
                        mu: float = 2e-5, mt: float = 1e-5,
                        deps: float = 5e-7, oeps: float = 0.0):
        n = origins.shape[0]
        out = np.empty(n, np.uint8)
        stable = np.empty(n, np.uint8)
        self._lib.vkrt_trace_occluded_stable(
            self._handle,
            np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(dirs, np.float32),
            np.ascontiguousarray(np.broadcast_to(
                np.asarray(tmax, np.float32), (n,))),
            n, np.float32(tmin), np.float32(mu), np.float32(mt),
            np.float32(deps), np.float32(oeps), out, stable)
        return out.astype(bool), stable.astype(bool)
