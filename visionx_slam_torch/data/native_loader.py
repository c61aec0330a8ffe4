"""ctypes bindings for the native (C++) decode/prefetch runtime.

The reference's loader/decoder runtime is C++ (dataset parsing + cv::imread
in the tracking-thread loop, system.cpp:38-53); ``native/vxs_io.cpp`` is
this repository's equivalent: libpng decode + a bounded multi-threaded
prefetch pipeline that overlaps host decode with device compute. These are
the port's own ctypes bindings over the same ``native/libvxs_io.so`` that
the JAX package's ``data/native_loader.py`` loads, built with
``make -C native`` at first use. Where the library is missing and cannot be
built (no ``make``, no compiler, no libpng headers), ``available()`` is
false and the single-image functions take the pure-Python loader
(``data/tum.py`` on ``data/png.py``).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger("vxs.data.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libvxs_io.so"))

_lib = None


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR)],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception as e:  # noqa: BLE001 — any build failure means fallback
        log.warning("native build failed (%s); using Python loader", e)
        return False


def _stale() -> bool:
    """True when the .so is missing or older than its C++ source (a stale
    or tampered binary must never be silently preferred)."""
    if not os.path.exists(_SO_PATH):
        return True
    src = os.path.join(_NATIVE_DIR, "vxs_io.cpp")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
    except OSError:
        return True


def load_library():
    """Load (building if needed/stale) libvxs_io; returns None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("VXS_NATIVE", "1") == "0":
        return None
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        log.warning("cannot load %s: %s", _SO_PATH, e)
        return None

    lib.vxs_decode_gray.restype = ctypes.c_int
    lib.vxs_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vxs_decode_depth.restype = ctypes.c_int
    lib.vxs_decode_depth.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_double,
    ]
    lib.vxs_prefetch_create.restype = ctypes.c_void_p
    lib.vxs_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    lib.vxs_prefetch_next.restype = ctypes.c_int
    lib.vxs_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vxs_prefetch_destroy.restype = None
    lib.vxs_prefetch_destroy.argtypes = [ctypes.c_void_p]
    lib.vxs_prefetch_decode_seconds.restype = ctypes.c_double
    lib.vxs_prefetch_decode_seconds.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def decode_gray(path: str, max_hw=(1024, 1280)) -> np.ndarray:
    lib = load_library()
    if lib is None:
        from . import tum

        return tum.load_rgb_gray(path)
    buf = np.empty(max_hw[0] * max_hw[1], np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vxs_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"native gray decode failed: {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def decode_depth(path: str, scale: float = 5000.0, max_hw=(1024, 1280)) -> np.ndarray:
    lib = load_library()
    if lib is None:
        from . import tum

        return tum.load_depth_m(path)
    buf = np.empty(max_hw[0] * max_hw[1], np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vxs_decode_depth(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size, ctypes.byref(w), ctypes.byref(h), scale,
    )
    if rc != 0:
        raise IOError(f"native depth decode failed: {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class NativePrefetcher:
    """Bounded threaded decode pipeline over (rgb, depth) path pairs.

    Iterate to receive (gray u8 [H,W], depth f32 [H,W]) in dataset order
    while worker threads decode ahead.
    """

    def __init__(self, rgb_paths, depth_paths, queue_depth: int = 4,
                 n_threads: int = 2, depth_scale: float = 5000.0,
                 max_hw=(1024, 1280)):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._n = len(rgb_paths)
        self._max_hw = max_hw
        # keep encoded strings alive for the duration of the prefetcher
        self._rgb_bytes = [p.encode() for p in rgb_paths]
        self._depth_bytes = [p.encode() for p in depth_paths]
        rgb_arr = (ctypes.c_char_p * self._n)(*self._rgb_bytes)
        depth_arr = (ctypes.c_char_p * self._n)(*self._depth_bytes)
        self._handle = lib.vxs_prefetch_create(
            rgb_arr, depth_arr, self._n, queue_depth, n_threads, depth_scale
        )
        self._closed = False
        self._decode_s = 0.0

    def __iter__(self):
        gray = np.empty(self._max_hw[0] * self._max_hw[1], np.uint8)
        depth = np.empty(self._max_hw[0] * self._max_hw[1], np.float32)
        w = ctypes.c_int()
        h = ctypes.c_int()
        while True:
            rc = self._lib.vxs_prefetch_next(
                self._handle,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), gray.size,
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), depth.size,
                ctypes.byref(w), ctypes.byref(h),
            )
            if rc == 1:
                return
            if rc == 2:
                raise IOError("native prefetch: frame decode failed")
            hw = (h.value, w.value)
            yield (
                gray[: hw[0] * hw[1]].reshape(hw).copy(),
                depth[: hw[0] * hw[1]].reshape(hw).copy(),
            )

    def decode_seconds(self) -> float:
        """Total worker decode time so far (overlapped with compute)."""
        if self._closed:
            return self._decode_s
        self._decode_s = float(
            self._lib.vxs_prefetch_decode_seconds(self._handle)
        )
        return self._decode_s

    def close(self):
        if not self._closed:
            self.decode_seconds()
            self._lib.vxs_prefetch_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
