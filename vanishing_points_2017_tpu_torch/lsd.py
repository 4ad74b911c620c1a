"""Host LSD line-segment detector: a ctypes binding of the port's copy of
the repository's C++ LSD, ``csrc/lsd.cpp`` (byte for byte the JAX
package's ``lsd/lsd.cpp``).

The source is compiled with g++ and the JAX binding's flags (``-O3
-march=native``), so both packages give identical segments on one
machine. The library goes into ``build/lsd/`` of the checkout under a name
hashed from the source, the flags and the host CPU (``hostbuild.py``), so a
``build/`` carried to another machine rebuilds. The build runs at first
use.

The segments depend on the host, as the reference's do: ``-march=native``
lets g++ contract multiply-adds into FMA instructions where the CPU has
them. On an Intel Xeon with FMA (g++ 12.2, ``scripts/compare_lsd_flags.py``)
the four bundled scenes gave 265 against 264 segments on scene 0 with and
without ``-ffp-contract=off``, and the same counts with endpoints within
3.4e-13 px on scenes 1-3; ``-march=native -ffp-contract=off``, plain
``-O3`` and ``-O3 -ffp-contract=off`` gave identical segments. Portable
flags would therefore part the port from the JAX binding on any FMA host;
the flags stay the reference's, and the library's name follows the CPU.

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

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "lsd.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lsd")
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
