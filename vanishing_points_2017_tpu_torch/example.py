"""Example driver of the PyTorch port (the root ``example.py`` of the JAX
package, on a torch device): the host path on the bundled example scenes.

    python -m vanishing_points_2017_tpu_torch.example [--device cuda]

Each image goes through ``Pipeline.process(image, target_size=640)``
(host LSD, then render -> CNN -> EM -> horizon on the device); the driver
prints the horizon's two points in pixels and, where a
``<image>.horizon.npy`` ground truth lies beside the image, the normalized
horizon error. ``--images`` takes other PNG or baseline JPEG files, or
directories of them; ``--weights``/``--mean`` also take Caffe's
``.caffemodel``/``.binaryproto``. ``--show`` writes each image's result
figure (``viz.show_em_result``) into ``example/`` under
``config.Paths().result_dir`` (``build/results/`` of this checkout unless
``$VP_TPU_RESULTS`` is set); it needs matplotlib and raises where that is
not installed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .config import Paths

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(_ROOT, "assets", "examples")
RESULTS = os.path.join(Paths().result_dir, "example")
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def image_paths(args_images: list[str] | None) -> list[str]:
    if args_images is None:
        paths = sorted(os.path.join(EXAMPLES, p) for p in os.listdir(EXAMPLES)
                       if p.endswith(".png"))
        if not paths:
            raise FileNotFoundError(f"no example scenes in {EXAMPLES}")
        return paths
    paths = []
    for p in args_images:
        if os.path.isdir(p):
            paths += sorted(os.path.join(p, f) for f in os.listdir(p)
                            if f.lower().endswith(IMAGE_SUFFIXES))
        else:
            paths.append(p)
    return paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--mean", default=None)
    ap.add_argument("--images", nargs="*", default=None, metavar="PATH",
                    help="run on these image files (or all jpg/png in a "
                         "directory) instead of the bundled scenes")
    ap.add_argument("--show", action="store_true",
                    help="write each image's result figure into example/ "
                         "under the result directory (needs matplotlib)")
    ap.add_argument("--consensus", type=int, default=0, metavar="K",
                    help="K-member dropout-ensemble horizon (medoid pick); "
                         "0 = single EM")
    args = ap.parse_args(argv)

    from . import weights as wload
    from .data import io as dio
    from .pipeline import Pipeline, PipelineConfig, require_device

    dev = require_device(args.device)
    params, mean = wload.load_params_and_mean(args.weights, args.mean,
                                              device=dev)
    pipe = Pipeline(params, mean, PipelineConfig(
        horizon_consensus=args.consensus), device=dev)
    paths = image_paths(args.images)
    if not paths:
        ap.error("--images resolved to no jpg/jpeg/png files "
                 f"(got: {args.images!r})")

    for path in paths:
        print("image file: ", path)
        image = dio.load_image(path)
        res = pipe.process(image, target_size=640)

        hp1, hp2 = res["hp1"].copy(), res["hp2"].copy()
        width, height = image.shape[1], image.shape[0]
        scale = 640.0 / max(width, height)
        width, height = width * scale, height * scale
        for hp in (hp1, hp2):
            hp[0] = hp[0] * 640 / 2.0 + width / 2.0
            hp[1] = -hp[1] * 640 / 2.0 + height / 2.0
        print(hp1)
        print(hp2)

        gt = os.path.splitext(path)[0] + ".horizon.npy"
        if os.path.isfile(gt):
            err = dio.normalized_horizon_error(
                Pipeline.horizon_line(res), np.load(gt).astype(np.float64),
                int(width), int(height))
            print(f"horizon error vs ground truth: {err:.4f}")

        if args.show:
            from . import viz

            os.makedirs(RESULTS, exist_ok=True)
            out_png = os.path.join(
                RESULTS,
                os.path.splitext(os.path.basename(path))[0] + ".result.png")
            viz.show_em_result(res, dio.resize_max(image, 640), out_png,
                               maxbest=3, horizon=(hp1, hp2))
            print("wrote", out_png)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
