"""Compare the port's host LSD built with other g++ flags, on the CPU.

Builds ``vanishing_points_2017_tpu_torch/csrc/lsd.cpp`` with the JAX
binding's flags (``-O3 -march=native``) and with three variants without
fused multiply-adds (``-O3 -ffp-contract=off``, ``-O3 -march=native
-ffp-contract=off``, plain ``-O3``) into ``build/lsd_flags/``, runs each on
the four bundled scenes, and prints per scene each build's segment count
and the largest endpoint difference to the ``-ffp-contract=off`` build
(where the counts agree). It shows that the segments' dependence on the
host comes from FMA contraction, which ``-march=native`` allows.

    python scripts/compare_lsd_flags.py
"""

from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "native": ("-O3", "-march=native"),
    "nocontract": ("-O3", "-ffp-contract=off"),
    "native_nocontract": ("-O3", "-march=native", "-ffp-contract=off"),
    "plain": ("-O3",),
}


def main() -> None:
    sys.path.insert(0, ROOT)
    import numpy as np

    from vanishing_points_2017_tpu_torch import hostbuild, lsd
    from vanishing_points_2017_tpu_torch.data import io as dio

    build = os.path.join(ROOT, "build", "lsd_flags")
    libs = {}
    for name, flags in VARIANTS.items():
        path = hostbuild.build_shared(
            lsd.SOURCE, (*flags, "-shared", "-fPIC", "-std=c++17"), build,
            f"liblsd_{name}")
        lib = ctypes.CDLL(path)
        lib.lsd_detect.restype = ctypes.c_int
        lib.lsd_detect.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int)]
        libs[name] = lib

    def detect(lib, img):
        img = np.ascontiguousarray(img, np.float64)
        out, n = ctypes.POINTER(ctypes.c_double)(), ctypes.c_int()
        lib.lsd_detect(img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       img.shape[1], img.shape[0], ctypes.byref(out),
                       ctypes.byref(n))
        return np.ctypeslib.as_array(out, shape=(n.value, 7)).copy()

    for i in range(4):
        img = dio.rgb2gray(dio.load_image(os.path.join(
            ROOT, "assets", "examples", f"scene_{i}.png"))) * 255.0
        segs = {name: detect(lib, img) for name, lib in libs.items()}
        base = segs["nocontract"]
        cells = []
        for name, a in segs.items():
            d = (f", endpoints max |d| {np.abs(a[:, :4] - base[:, :4]).max():.3g}"
                 if a.shape == base.shape else "")
            cells.append(f"{name} {a.shape[0]} segments{d}")
        print(f"scene {i}: " + "; ".join(cells))


if __name__ == "__main__":
    main()
