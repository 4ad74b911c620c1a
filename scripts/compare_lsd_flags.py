"""Compare the port's host LSD built with other g++ flags, or by another
g++, on the CPU.

With no option: builds ``vanishing_points_2017_tpu_torch/csrc/lsd.cpp``
with the JAX binding's flags (``-O3 -march=native``) and with three
variants without fused multiply-adds (``-O3 -ffp-contract=off``, ``-O3
-march=native -ffp-contract=off``, plain ``-O3``) into ``build/lsd/``,
runs each on the four bundled scenes, and prints per scene each build's
segment count and the largest endpoint difference to the
``-ffp-contract=off`` build (where the counts agree). It shows that the
segments' dependence on the host comes from FMA contraction, which
``-march=native`` allows.

``--export DIR`` builds the four variants with this host's g++ and copies
them into DIR (``liblsd_<variant>.so``), with ``host.txt`` naming this
host's ``-march=native`` and g++, and P1026's grayscale image as this
host decodes it (``p1026_gray.npy``): a library to carry to another host,
where its code runs against that host's libm and CPU.

``--carried DIR``, on that other host, runs P1026
(``assets/examples/progressive/P1026.jpg``, the host path's LSD input)
through each variant built here and through the same variant carried in
DIR, and prints per variant each build's segment count and largest
endpoint gap to JAX's P1026 segments of
``assets/examples/jax_reference_em.npz``, and the gap between the two
builds; beside it, this host's and the carried host's g++ and target,
whether the decoded grayscale image equals the carried one, and whether
the port's LSD source is still byte for byte the JAX package's. A
carried build that gives JAX's segments where this host's build of the
same source and flags departs places the departure in the compiler's
code, not in the source, the libm or the CPU.

    python scripts/compare_lsd_flags.py [--export DIR | --carried DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "native": ("-O3", "-march=native"),
    "nocontract": ("-O3", "-ffp-contract=off"),
    "native_nocontract": ("-O3", "-march=native", "-ffp-contract=off"),
    "plain": ("-O3",),
}
PHOTO = os.path.join(ROOT, "assets", "examples", "progressive", "P1026.jpg")
REF = os.path.join(ROOT, "assets", "examples", "jax_reference_em.npz")
JAX_SOURCE = os.path.join(ROOT, "vanishing_points_2017_tpu", "lsd", "lsd.cpp")


def host() -> str:
    """This host's ``-march=native`` target and g++ version."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True,
                            check=True).stdout
    march = next(ln.split()[1] for ln in target.splitlines()
                 if ln.split()[:1] == ["-march="])
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    return f"-march=native is {march}, {version}"


def _flags(name: str) -> tuple:
    from vanishing_points_2017_tpu_torch import lsd

    return (*VARIANTS[name], *lsd.FLAGS[2:])


def _gray():
    from vanishing_points_2017_tpu_torch.data import io as dio

    return dio.rgb2gray(dio.load_image(PHOTO)) * 255.0


def _build(name: str) -> str:
    """The library of ``lsd.cpp`` under variant ``name``, built here."""
    from vanishing_points_2017_tpu_torch import hostbuild, lsd

    return hostbuild.build_shared(lsd.SOURCE, _flags(name), lsd.BUILD_DIR,
                                  "liblsd")


def _bind(path: str):
    import ctypes

    lib = ctypes.CDLL(path)
    lib.lsd_detect.restype = ctypes.c_int
    lib.lsd_detect.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int)]
    lib.lsd_free.restype = None
    lib.lsd_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    return lib


def detect(path: str, gray):
    """LSD's (N, 7) float64 segments of ``gray`` from the library at
    ``path``."""
    import ctypes

    import numpy as np

    lib = _bind(path)
    img = np.ascontiguousarray(gray, np.float64)
    out, n = ctypes.POINTER(ctypes.c_double)(), ctypes.c_int()
    lib.lsd_detect(img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   img.shape[1], img.shape[0], ctypes.byref(out),
                   ctypes.byref(n))
    raw = np.ctypeslib.as_array(out, shape=(n.value, 7)).copy()
    lib.lsd_free(out)
    return raw


def _segments(path: str, gray):
    """P1026's normalized (N, 4) float32 segments, as ``data/io.py``'s
    ``detect_lsd_lines`` makes them."""
    import numpy as np

    from vanishing_points_2017_tpu_torch.data import io as dio

    return dio.normalize_segments(detect(path, gray), gray.shape[1],
                                  gray.shape[0]).astype(np.float32)


def segment_gap(a, b) -> float:
    """Largest over the segments of either set of the distance (largest
    coordinate, endpoint order free) to the closest of the other set."""
    import numpy as np

    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else float("inf")

    def one_way(x, y):
        d1 = np.abs(y[None] - x[:, None]).max(-1)
        d2 = np.abs(y[None][..., [2, 3, 0, 1]] - x[:, None]).max(-1)
        return float(np.minimum(d1, d2).min(1).max())

    return max(one_way(a, b), one_way(b, a))


def scenes() -> None:
    import numpy as np

    from vanishing_points_2017_tpu_torch.data import io as dio

    for i in range(4):
        img = dio.rgb2gray(dio.load_image(os.path.join(
            ROOT, "assets", "examples", f"scene_{i}.png"))) * 255.0
        segs = {name: detect(_build(name), img) for name in VARIANTS}
        base = segs["nocontract"]
        cells = []
        for name, a in segs.items():
            d = (f", endpoints max |d| "
                 f"{np.abs(a[:, :4] - base[:, :4]).max():.3g}"
                 if a.shape == base.shape else "")
            cells.append(f"{name} {a.shape[0]} segments{d}")
        print(f"scene {i}: " + "; ".join(cells))


def export(out: str) -> None:
    import numpy as np

    os.makedirs(out, exist_ok=True)
    for name in VARIANTS:
        shutil.copyfile(_build(name), os.path.join(out, f"liblsd_{name}.so"))
    with open(os.path.join(out, "host.txt"), "w") as f:
        f.write(host() + "\n")
    np.save(os.path.join(out, "p1026_gray.npy"), _gray())
    print(f"exported {len(VARIANTS)} builds to {out} ({host()})")


def compare(src: str) -> dict:
    """P1026 through each variant built here and carried in ``src`` ->
    the hosts, whether the sources and grayscale images are equal, and
    per variant the segment counts and gaps (normalized units)."""
    import numpy as np

    from vanishing_points_2017_tpu_torch import lsd

    ref = np.load(REF)
    jax_seg = ref["p1026_segments"][ref["p1026_segment_mask"]]
    with open(JAX_SOURCE, "rb") as f, open(lsd.SOURCE, "rb") as g:
        same_source = f.read() == g.read()
    with open(os.path.join(src, "host.txt")) as f:
        other = f.read().strip()
    gray = _gray()
    carried_gray = np.load(os.path.join(src, "p1026_gray.npy"))
    rows = {}
    for name in VARIANTS:
        here = _segments(_build(name), gray)
        there = _segments(os.path.join(src, f"liblsd_{name}.so"), gray)
        rows[name] = dict(
            n_here=len(here), n_carried=len(there), n_jax=len(jax_seg),
            here_jax=segment_gap(here, jax_seg),
            carried_jax=segment_gap(there, jax_seg),
            here_carried=segment_gap(here, there))
    return dict(host=host(), carried_host=other,
                oracle_host=str(ref["p1026_lsd_target"]),
                same_source=same_source,
                same_gray=bool(np.array_equal(gray, carried_gray)),
                gray_diff=float(np.abs(gray - carried_gray).max()),
                px=max(gray.shape) / 2, rows=rows)


def carried(src: str) -> None:
    out = compare(src)
    print(f"this host: {out['host']}; carried builds: "
          f"{out['carried_host']}; the oracle's LSD build: "
          f"{out['oracle_host']}")
    print(f"the port's lsd.cpp is the JAX package's byte for byte: "
          f"{out['same_source']}; P1026's grayscale image equals the "
          f"carried one: {out['same_gray']} (largest difference "
          f"{out['gray_diff']:.3g})")
    px = out["px"]
    for name, r in out["rows"].items():
        cells = [f"{who} {r['n_' + key]} segments, gap to JAX's "
                 f"{r['n_jax']} {r[key + '_jax']:.3g} "
                 f"({r[key + '_jax'] * px:.3g} px)"
                 for who, key in (("built here", "here"),
                                  ("carried", "carried"))]
        print(f"p1026 {name} ({' '.join(VARIANTS[name])}): "
              + "; ".join(cells) + f"; here vs carried "
              f"{r['here_carried']:.3g} ({r['here_carried'] * px:.3g} px)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--export", metavar="DIR")
    group.add_argument("--carried", metavar="DIR")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.export:
        export(args.export)
    elif args.carried:
        carried(args.carried)
    else:
        scenes()


if __name__ == "__main__":
    main()
