"""Host LSD line-segment detector: a ctypes binding of the repository's one
C++ LSD source, ``vanishing_points_2017_tpu/lsd/lsd.cpp``.

The source is compiled by its path (nothing of the JAX package is
imported, and the file is not copied) with g++ and the JAX binding's flags,
so both packages give identical segments on one machine. The library goes
into ``build/lsd/`` of the checkout under a name hashed from the source
and the flags, as ``kernels.py`` names the CUDA libraries; nothing is
written beside the JAX package's source. The build runs at first use.

``detect_line_segments(image)`` takes a 2-D grayscale image in [0, 255]
and returns (N, 7) float64 columns x1, y1, x2, y2, width, precision,
-log10(NFA), like the reference's ``evaluation.py:229-251`` call site.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import hostbuild

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "vanishing_points_2017_tpu", "lsd", "lsd.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "lsd")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    return hostbuild.library_path(SOURCE, FLAGS, BUILD_DIR, "liblsd")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(hostbuild.build_shared(SOURCE, FLAGS,
                                                     BUILD_DIR, "liblsd"))
            lib.lsd_detect.restype = ctypes.c_int
            lib.lsd_detect.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_int)]
            lib.lsd_free.restype = None
            lib.lsd_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
            _lib = lib
        return _lib


def detect_line_segments(image: np.ndarray) -> np.ndarray:
    """Run LSD. image: (H, W) grayscale in [0, 255].

    Returns (N, 7) float64: x1, y1, x2, y2, width, precision, -log10(NFA).
    """
    img = np.ascontiguousarray(image, dtype=np.float64)
    if img.ndim != 2:
        raise ValueError("expected a 2-D grayscale image")
    lib = _load()
    h, w = img.shape
    out = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int()
    rc = lib.lsd_detect(img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        w, h, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"lsd_detect failed with code {rc}")
    try:
        if n.value == 0:
            return np.zeros((0, 7), np.float64)
        return np.ctypeslib.as_array(out, shape=(n.value, 7)).copy()
    finally:
        lib.lsd_free(out)
