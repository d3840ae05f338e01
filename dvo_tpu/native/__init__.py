"""ctypes bindings for the native C++ data plane (PNG decode, undistortion
remap, threaded prefetch loader).

``libdvonative.so`` is built from ``loader.cpp`` by the Makefile on first
use in each process (``make`` is a no-op while the library is newer than
its source; g++ and libpng are needed).  Every entry point has a host-side
numpy fallback (``dvo_tpu.utils.png``, ``dvo_tpu.utils.datasets``), so the
framework works without the native lib — it is a throughput optimization
of the host data plane, mirroring the reference's C++ loader
(src/core/loader.cpp).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libdvonative.so")
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    """Run ``make``; it rebuilds only when ``loader.cpp`` is newer, and
    renames the result into place (see the Makefile)."""
    try:
        subprocess.run(
            ["make", "-s", "-C", _DIR], check=True, capture_output=True,
            text=True,
        )
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"native build failed: {detail.strip()}") from e


def load_library() -> ctypes.CDLL:
    """Build (when stale) and load the native library.  Never loads a
    library the build did not just confirm: a copy from another machine
    could hold instructions this CPU lacks."""
    global _lib
    if _lib is not None:
        return _lib
    _build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.dvo_png_info.restype = ctypes.c_int
    lib.dvo_png_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dvo_decode_png_f32.restype = ctypes.c_int
    lib.dvo_decode_png_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
    ]
    lib.dvo_remap_nearest.restype = None
    lib.dvo_remap_nearest.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.dvo_prefetch_create.restype = ctypes.c_void_p
    lib.dvo_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    lib.dvo_prefetch_next.restype = ctypes.c_int
    lib.dvo_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.dvo_prefetch_dims.restype = None
    lib.dvo_prefetch_dims.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
    ]
    lib.dvo_prefetch_destroy.restype = None
    lib.dvo_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def png_info(path: str) -> Tuple[int, int, int]:
    lib = load_library()
    w = ctypes.c_int()
    h = ctypes.c_int()
    d = ctypes.c_int()
    rc = lib.dvo_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(d))
    if rc != 0:
        raise IOError(f"png_info({path}) failed: {rc}")
    return w.value, h.value, d.value


def decode_png_f32(path: str, scale: float) -> np.ndarray:
    """Decode to float32 gray * scale (8-bit RGB uses BGR2GRAY luma)."""
    lib = load_library()
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.float32)
    rc = lib.dvo_decode_png_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h,
        ctypes.c_float(scale),
    )
    if rc != 0:
        raise IOError(f"decode_png_f32({path}) failed: {rc}")
    return out


def remap_nearest(src: np.ndarray, map_xy: np.ndarray, border: float):
    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    map_xy = np.ascontiguousarray(map_xy, np.float32)
    h, w = map_xy.shape[:2]
    dst = np.empty((h, w), np.float32)
    valid = np.empty((h, w), np.uint8)
    lib.dvo_remap_nearest(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0], src.shape[1],
        map_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        ctypes.c_float(border),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return dst, valid.astype(bool)


class PrefetchLoader:
    """Threaded decode(+remap) pipeline over a list of PNG paths; yields
    (index, image (H, W) f32, valid (H, W) bool) in order."""

    def __init__(
        self,
        paths: List[str],
        scale: float,
        map_xy: Optional[np.ndarray] = None,
        border: float = 0.0,
        threads: int = 2,
    ):
        lib = load_library()
        w, h, _ = png_info(paths[0])
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        if map_xy is not None:
            map_xy = np.ascontiguousarray(map_xy, np.float32)
            mp = map_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            mh, mw = map_xy.shape[:2]
        else:
            mp, mh, mw = None, 0, 0
        self._keepalive = (arr, map_xy)
        self._lib = lib
        self._handle = lib.dvo_prefetch_create(
            arr, len(paths), w, h, ctypes.c_float(scale), mp, mh, mw,
            ctypes.c_float(border), threads,
        )
        oh = ctypes.c_int()
        ow = ctypes.c_int()
        lib.dvo_prefetch_dims(self._handle, ctypes.byref(oh), ctypes.byref(ow))
        self.shape = (oh.value, ow.value)
        self._n = len(paths)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        h, w = self.shape
        out = np.empty((h, w), np.float32)
        valid = np.empty((h, w), np.uint8)
        idx = self._lib.dvo_prefetch_next(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        self._i += 1
        if idx < 0:
            raise IOError(f"prefetch decode failed at frame {self._i - 1}: {idx}")
        return idx, out, valid.astype(bool)

    def close(self):
        if self._handle:
            self._lib.dvo_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
