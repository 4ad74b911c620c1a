"""Miniature YUD / ECD / HLW data sets in each data set's exact layout
(``data/minisets.py`` of the JAX package).

The real data sets are downloads, so the three real-format code paths
(``.mat`` camera and VP parsing with the reference's hard-coded (13, -11)
principal point, ECD's ``*hor.mat`` pixel-frame horizon, HLW's
``metadata.csv`` + ``split/test.txt``) would never run end to end. These
generators write a tiny data set on disk from synthetic Manhattan scenes
with exact horizons, so ``benchmark --yud/--ecd/--hlw --dataset_dir
<mini>`` runs the whole driver: JPEG decode -> (ECD/HLW) resize to 800 ->
LSD -> device stage -> ground-truth parsing -> horizon error -> AUC.

Seeds, draw order and the ``.mat``/``.csv`` layout are the JAX
generators'; the images are drawn by ``datasets.render_scene_image_wh``
and written by ``jpeg.encode_jpeg`` (grayscale as RGB, quality 92), which
give PIL's pixels and PIL's bytes, so a mini is the same files whichever
package wrote it. The ground truth is written by inverting each adapter's
transform, so the adapter must give back the scene's horizon exactly.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..models import synth
from . import jpeg
from .datasets import render_scene_image_wh

# the YUD camera constants that the adapter (and the reference) applies
YUD_F_OVER_PS = 675.0
YUD_PP = np.array([13.0, -11.0])


def _save_jpeg(arr: np.ndarray, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(jpeg.encode_jpeg(np.stack([arr] * 3, axis=-1), quality=92))


def _scenes(count: int, seed: int):
    rng = np.random.default_rng(seed)
    return [synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 45)),
                             outliers=int(rng.integers(5, 15)))
            for _ in range(count)], rng


def _horizon_points(horizon: np.ndarray) -> list:
    """The horizon's points at x = -0.5 and x = 0.5, normalized frame."""
    pts = []
    for x in (-0.5, 0.5):
        p = np.cross(horizon.astype(np.float64), np.array([-1.0, 0.0, x]))
        pts.append(p / p[2])
    return pts


def make_mini_yud(root: str, n_eval: int = 2, seed: int = 101) -> list:
    """York Urban layout: P10NN/P10NN.jpg + *GroundTruthVP_CamParams.mat,
    cameraParameters.mat at the root; 640x480 images; the first 25 are the
    train/val split that the protocol skips.

    The adapter computes t = S K vp / (K vp)_z with S = 2/640 and K
    carrying the hard-coded (13, -11) principal point; stored is
    vp = K^-1 (320 x, 320 y, 1) for a normalized-frame VP (x, y), columns
    (horizon1, zenith, horizon2)."""
    import scipy.io as sio

    scenes, rng = _scenes(25 + n_eval, seed)
    os.makedirs(root, exist_ok=True)
    sio.savemat(os.path.join(root, "cameraParameters.mat"),
                {"focal": np.array([[YUD_F_OVER_PS]]),
                 "pixelSize": np.array([[1.0]]),
                 "pp": np.array([[307.0, 251.0]])})  # ignored, like the ref
    k_inv = np.linalg.inv(np.array([[YUD_F_OVER_PS, 0, YUD_PP[0]],
                                    [0, YUD_F_OVER_PS, YUD_PP[1]],
                                    [0, 0, 1.0]]))
    for i, scene in enumerate(scenes):
        name = f"P{1001 + i}"
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        _save_jpeg(render_scene_image_wh(scene, 640, 480, rng=rng),
                   os.path.join(d, f"{name}.jpg"))
        zenith = int(np.argmax(np.abs(scene.vps[:, 1])))
        hor = [k for k in range(3) if k != zenith]
        vp = np.zeros((3, 3))
        for c, k in enumerate([hor[0], zenith, hor[1]]):
            v = scene.vps[k].astype(np.float64)
            cam = k_inv @ np.array([320.0 * v[0] / v[2],
                                    320.0 * v[1] / v[2], 1.0])
            vp[:, c] = cam / np.linalg.norm(cam)
        sio.savemat(os.path.join(d, f"{name}GroundTruthVP_CamParams.mat"),
                    {"vp": vp})
    return scenes


def make_mini_ecd(root: str, n_eval: int = 1, seed: int = 202) -> list:
    """Eurasian Cities layout: NNNN.jpg + NNNNhor.mat at the root; original
    size 1024x768 (so the resize to 800 runs); the first 25 skipped.

    ``horizon`` is the line in top-left-origin, y-down pixel coordinates
    of the original image, through two normalized-frame horizon points
    mapped by px = x s + w/2, py = -y s + h/2."""
    import scipy.io as sio

    w, h = 1024, 768
    s = max(w, h) / 2.0
    scenes, rng = _scenes(25 + n_eval, seed)
    os.makedirs(root, exist_ok=True)
    for i, scene in enumerate(scenes):
        name = f"{i + 1:04d}"
        _save_jpeg(render_scene_image_wh(scene, w, h, rng=rng),
                   os.path.join(root, f"{name}.jpg"))
        pts = [np.array([p[0] * s + w / 2.0, -p[1] * s + h / 2.0, 1.0])
               for p in _horizon_points(scene.horizon)]
        sio.savemat(os.path.join(root, f"{name}hor.mat"),
                    {"horizon": np.cross(pts[0], pts[1])})
    return scenes


def make_mini_hlw(root: str, n_eval: int = 3, seed: int = 303) -> list:
    """HLW layout: images/<name>.jpg, split/test.txt, metadata.csv; original
    size 900x600; nothing skipped. The metadata's coordinates are
    centre-origin, y-up, in pixels of the original size (the adapter
    divides by half its longer side)."""
    w, h = 900, 600
    s = max(w, h) / 2.0
    scenes, rng = _scenes(n_eval, seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "split"), exist_ok=True)
    rows, names = [], []
    for i, scene in enumerate(scenes):
        name = f"hlw_{i:04d}.jpg"
        names.append(name)
        _save_jpeg(render_scene_image_wh(scene, w, h, rng=rng),
                   os.path.join(root, "images", name))
        p1, p2 = _horizon_points(scene.horizon)
        rows.append([name, h, w, p1[0] * s, p1[1] * s, p2[0] * s, p2[1] * s])
    with open(os.path.join(root, "metadata.csv"), "w", newline="") as fh:
        csv.writer(fh).writerows(rows)
    with open(os.path.join(root, "split", "test.txt"), "w") as fh:
        fh.write("\n".join(names) + "\n")
    return scenes
