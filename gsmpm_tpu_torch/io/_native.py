"""ctypes bridge to the native IO tier (csrc/gsmpm_native.cpp,
gsmpm_video.cpp, gsmpm_png.cpp).

Port of gsmpm_tpu/io/_native.py, plus the PNG row unfilter that
io/dataset.read_png takes (gsmpm_tpu decodes PNGs with imageio).  The
library is built with g++ on first use (utils/build.py:
``build/libgsmpm_native-<hash>.so``, written to a temporary file and moved
into place) and loaded with ctypes.  Every entry point returns None (or
False) on any failure so callers fall back to the pure-Python codecs
(io/ply.py, io/dataset.py): the native tier is an accelerator, not a
dependency.  ``status()`` says ``"loaded"``, or why the tier is not: no
compiler, a build error, or ``GSMPM_NO_NATIVE``.

Set GSMPM_NO_NATIVE=1 to disable it entirely.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import numpy as np

from gsmpm_tpu_torch.utils import build

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_STATUS = "not tried"


def _bind(lib: ctypes.CDLL) -> None:
    lib.gsn_ply_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.gsn_ply_header.restype = ctypes.c_int
    lib.gsn_ply_read_f32_planar.argtypes = [
        ctypes.c_char_p,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.gsn_ply_read_f32_planar.restype = ctypes.c_int
    lib.gsn_ply_write_f32_planar.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.gsn_ply_write_f32_planar.restype = ctypes.c_int
    lib.gsn_avi_begin.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gsn_avi_begin.restype = ctypes.c_void_p
    lib.gsn_avi_add_frame.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    lib.gsn_avi_add_frame.restype = ctypes.c_int
    lib.gsn_avi_end.argtypes = [ctypes.c_void_p]
    lib.gsn_avi_end.restype = ctypes.c_int
    lib.gsn_png_unfilter.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.gsn_png_unfilter.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _STATUS
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("GSMPM_NO_NATIVE"):
        _STATUS = "disabled by GSMPM_NO_NATIVE"
        return None
    try:
        build.build_all([build.NATIVE])
        lib = ctypes.CDLL(str(build.library_path(build.NATIVE)))
        _bind(lib)
    except (RuntimeError, OSError, AttributeError) as e:
        _STATUS = f"not loaded: {type(e).__name__}: {e}"
        return None
    _LIB, _STATUS = lib, "loaded"
    return _LIB


def status() -> str:
    """``"loaded"``, or why the native tier is not (loads it first)."""
    _load()
    return _STATUS


def _n_threads() -> int:
    return min(8, os.cpu_count() or 1)


def read_ply_f32_columns(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Fast path for all-float32 binary_little_endian vertex PLYs.

    Returns {prop_name: (n,) float32} or None (caller falls back).
    """
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_longlong()
    n_props = ctypes.c_int()
    names = ctypes.create_string_buffer(16384)
    off = ctypes.c_longlong()
    all_f32 = ctypes.c_int()
    rc = lib.gsn_ply_header(
        path.encode(), ctypes.byref(n), ctypes.byref(n_props), names,
        len(names), ctypes.byref(off), ctypes.byref(all_f32),
    )
    if rc != 0 or not all_f32.value or n.value <= 0:
        return None
    out = np.empty((n_props.value, n.value), np.float32)
    rc = lib.gsn_ply_read_f32_planar(
        path.encode(), off.value, n.value, n_props.value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _n_threads(),
    )
    if rc != 0:
        return None
    cols = names.value.decode().split("\n")
    return {name: out[i] for i, name in enumerate(cols)}


def write_ply_f32_planar(path: str, header: str, planar: np.ndarray) -> bool:
    """Write header + interleaved block from (n_props, n) f32 planar data."""
    lib = _load()
    if lib is None:
        return False
    planar = np.ascontiguousarray(planar, np.float32)
    rc = lib.gsn_ply_write_f32_planar(
        path.encode(), header.encode(),
        planar.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        planar.shape[1], planar.shape[0], _n_threads(),
    )
    return rc == 0


def png_unfilter(raw: bytes, h: int, stride: int,
                 bpp: int) -> Optional[np.ndarray]:
    """Undo the PNG row filters of ``raw`` (h rows of a filter byte and
    ``stride`` bytes, ``bpp`` bytes a pixel) -> (h, stride) uint8, or None
    when the tier is not loaded or a filter byte is not 0-4 (the numpy
    twin, io/dataset._unfilter_numpy, then decodes or raises)."""
    lib = _load()
    if lib is None:
        return None
    if len(raw) < h * (stride + 1) or not 1 <= bpp <= 8:
        raise ValueError(f"{len(raw)} bytes for {h} rows of {stride} + 1, "
                         f"{bpp} bytes a pixel")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    rc = lib.gsn_png_unfilter(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, stride, bpp,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if rc == 0 else None


class AviWriter:
    """Streaming MJPEG-in-AVI writer over the native encoder.

    Use as a context manager; add_frame takes (h, w, 3) uint8 RGB.  Raises
    RuntimeError if the native tier is unavailable (callers check
    avi_available() first).
    """

    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 quality: int = 90):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native video tier unavailable ({_STATUS})")
        self._lib = lib
        self._ctx = lib.gsn_avi_begin(path.encode(), width, height, fps)
        if not self._ctx:
            raise RuntimeError(f"gsn_avi_begin failed for {path}")
        self._w, self._h = width, height
        self._q = quality

    def add_frame(self, rgb: np.ndarray) -> None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.shape != (self._h, self._w, 3):
            raise ValueError(f"frame shape {rgb.shape} != "
                             f"({self._h}, {self._w}, 3)")
        rc = self._lib.gsn_avi_add_frame(
            self._ctx, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            self._q,
        )
        if rc != 0:
            raise RuntimeError("gsn_avi_add_frame failed")

    def close(self) -> None:
        if self._ctx:
            self._lib.gsn_avi_end(self._ctx)
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def avi_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "gsn_avi_begin")
