"""Dataset adapters (``data/datasets.py`` of the JAX package): YUD, ECD
and HLW ground truth, and the synthetic benchmark.

* **YUD** (York Urban): images ``P*/P*.jpg``; camera intrinsics from
  ``cameraParameters.mat`` with the reference's hard-coded principal point
  (13, -11) and scale 2/640 (a quirk that is kept); each image's
  ``*GroundTruthVP_CamParams.mat`` gives 3 orthogonal VPs, the horizon is
  VP1 x VP3. The first 25 images are train/val and skipped.
* **ECD** (Eurasian Cities): images ``*.jpg``; ``*hor.mat`` ground truth
  in pixel coordinates, converted to the normalized centre-origin y-up
  frame with the image's size (read from the file's header alone). The
  first 25 skipped; images are resized to fit 800 x 800.
* **HLW** (Horizon Lines in the Wild): the test list ``split/test.txt``;
  ``metadata.csv`` rows matched by basename give two horizon points scaled
  by the original image size. Resized to 800.
* **synthetic**: rendered Manhattan scenes with exact horizons, so the
  benchmark runs without the downloads.

Each adapter returns (records, number of leading records to skip).

The synthetic set draws random Manhattan scenes (``models/synth.py``) and
renders their segments as dark 2-px lines on a light background, with
mild sensor noise, so the host LSD and the on-device detector can
re-extract them; the ground-truth horizon is exact. The JAX package draws
with PIL's ``ImageDraw.line(width=2)``; the port does not use PIL, so
:func:`render_scene_image` reproduces that drawing pixel for pixel
(Pillow's ``ImagingDrawWideLine`` and its scanline polygon fill) in
numpy, and keeps the generator's stream in step with the JAX package's.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import os

import numpy as np

from ..models import synth
from . import io as dio

LINE_WIDTH = 2
_INK, _PAPER = 40, 220
_F32 = np.float32


@dataclasses.dataclass
class Record:
    name: str
    image_path: str | None = None
    image: np.ndarray | None = None  # inline image (synthetic)
    true_horizon: np.ndarray | None = None  # normalized homogeneous line


def horizon_from_points(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    return np.cross(p1, p2)


def yud_records(root: str) -> tuple[list[Record], int]:
    import scipy.io as sio

    cam = sio.loadmat(os.path.join(root, "cameraParameters.mat"))
    f = cam["focal"][0, 0]
    ps = cam["pixelSize"][0, 0]
    # the reference ignores cam['pp'] and hard-codes (13, -11)
    k_mat = np.array([[f / ps, 0, 13], [0, f / ps, -11], [0, 0, 1]])
    s_mat = np.array([[2.0 / 640, 0, 0], [0, 2.0 / 640, 0], [0, 0, 1]])

    records = []
    for img_path in sorted(glob.glob(os.path.join(root, "P*", "P*.jpg"))):
        image_id = os.path.splitext(os.path.basename(img_path))[0]
        gt_path = os.path.join(os.path.dirname(img_path),
                               f"{image_id}GroundTruthVP_CamParams.mat")
        true_h = None
        if os.path.isfile(gt_path):
            vp = np.asarray(sio.loadmat(gt_path)["vp"], np.float64)
            tv = k_mat @ vp
            tv = tv / tv[2:3, :]
            tv = s_mat @ tv
            true_h = horizon_from_points(tv[:, 0] / tv[2, 0],
                                         tv[:, 2] / tv[2, 2])
        records.append(Record(name=image_id, image_path=img_path,
                              true_horizon=true_h))
    return records, 25


def ecd_records(root: str) -> tuple[list[Record], int]:
    import scipy.io as sio

    records = []
    for img_path in sorted(glob.glob(os.path.join(root, "*.jpg"))):
        base = os.path.splitext(img_path)[0]
        true_h = None
        hor_path = f"{base}hor.mat"
        if os.path.isfile(hor_path):
            h, w = dio.image_size(img_path)
            scale = max(w, h)
            hor = np.squeeze(sio.loadmat(hor_path)["horizon"]).astype(
                np.float64)
            # intersect with the pixel verticals x = w and x = 0, then
            # normalize
            p1 = np.cross(hor, np.array([-1.0, 0.0, float(w)]))
            p2 = np.cross(hor, np.array([-1.0, 0.0, 0.0]))
            p1, p2 = p1 / p1[2], p2 / p2[2]
            for p in (p1, p2):
                p[0] = (p[0] - w / 2.0) / (scale / 2.0)
                p[1] = -(p[1] - h / 2.0) / (scale / 2.0)
            true_h = horizon_from_points(p1, p2)
        records.append(Record(name=os.path.basename(base),
                              image_path=img_path, true_horizon=true_h))
    return records, 25


def hlw_records(root: str) -> tuple[list[Record], int]:
    meta = {}
    with open(os.path.join(root, "metadata.csv")) as fh:
        for row in csv.reader(fh):
            meta[os.path.splitext(os.path.basename(row[0]))[0]] = row

    with open(os.path.join(root, "split", "test.txt")) as fh:
        names = [ln.strip() for ln in fh if ln.strip()]
    records = []
    for name in names:
        key = os.path.splitext(os.path.basename(name))[0]
        true_h = None
        if key in meta:
            row = meta[key]
            scale_orig = max(float(row[1]), float(row[2]))
            p1 = np.array([float(row[3]), float(row[4]), 1.0])
            p2 = np.array([float(row[5]), float(row[6]), 1.0])
            p1[0:2] /= scale_orig / 2.0
            p2[0:2] /= scale_orig / 2.0
            true_h = horizon_from_points(p1, p2)
        records.append(Record(name=key,
                              image_path=os.path.join(root, "images", name),
                              true_horizon=true_h))
    return records, 0


def _round_up(f: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP: half away from zero, in the argument's type."""
    a = np.floor(np.abs(f) + f.dtype.type(0.5))
    return np.where(f >= 0, a, -a).astype(np.int64)


def _round_down(f: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN: half towards zero, in the argument's type."""
    a = np.ceil(np.abs(f) - f.dtype.type(0.5))
    return np.where(f >= 0, a, -a).astype(np.int64)


def _wide_line_edges(x0, y0, x1, y1):
    """Pillow's ``ImagingDrawWideLine`` at width ``LINE_WIDTH``: each line
    (integer endpoints, arrays (L,)) becomes a 4-vertex polygon. Returns
    the (L, 4) edge tables of Pillow's ``add_edge`` (xmin, xmax, ymin,
    ymax, dx in float32, x0, y0, horizontal or not) and the mask of
    zero-length lines (drawn as a point)."""
    dx, dy = x1 - x0, y1 - y0
    point = (dx == 0) & (dy == 0)
    big = np.where(point, 1.0, np.hypot(dx, dy))
    small = np.array((LINE_WIDTH - 1) / 2.0)
    ratio_max = _round_up(small) / big
    ratio_min = _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    vx = np.stack([x0 - dxmin, x1 - dxmin, x1 + dxmax, x0 + dxmax], 1)
    vy = np.stack([y0 + dymax, y1 + dymax, y1 - dymin, y0 - dymin], 1)
    ax, ay = vx, vy
    bx, by = np.roll(vx, -1, 1), np.roll(vy, -1, 1)
    horiz = ay == by
    edx = np.where(horiz, _F32(0.0),
                   (bx - ax).astype(_F32)
                   / np.where(horiz, 1, by - ay).astype(_F32))
    edges = dict(xmin=np.minimum(ax, bx), xmax=np.maximum(ax, bx),
                 ymin=np.minimum(ay, by), ymax=np.maximum(ay, by),
                 dx=edx.astype(_F32), x0=ax, y0=ay, horiz=horiz)
    return edges, point


def _polygon_spans(edges: dict, height: int):
    """Pillow's ``polygon_generic`` on 4-edge polygons, all lines and all
    their scanlines at once: per scanline the edges' float32 crossings in
    edge order (a crossing at an edge's lower end twice, the "discontiguous
    corner" rewrite of an earlier crossing), sorted and filled pairwise
    from ROUND_UP to ROUND_DOWN. Returns spans (y, x_start, x_end)."""
    ymin_l = np.maximum(np.minimum(height - 1, edges["ymin"].min(1)), 0)
    ymax_l = np.minimum(np.maximum(0, edges["ymax"].max(1)), height)
    nrows = np.maximum(ymax_l - ymin_l + 1, 0)
    li = np.repeat(np.arange(nrows.size), nrows)
    first = np.cumsum(nrows) - nrows
    r = ymin_l[li] + (np.arange(li.size) - first[li])
    e = {k: v[li] for k, v in edges.items()}
    ymax = ymax_l[li]
    nonh = ~e["horiz"]
    tpos = np.cumsum(nonh, 1) - nonh  # index in Pillow's edge table

    def xat(q, rows):
        return ((rows - e["y0"][:, q]).astype(_F32) * e["dx"][:, q]
                + e["x0"][:, q].astype(_F32))

    m = li.size
    xx = np.full((m, 8), np.inf, _F32)
    j = np.zeros(m, np.int64)
    off = np.where(r == ymax, -1, 1)
    for q in range(4):
        dq = e["dx"][:, q]
        inr = nonh[:, q] & (e["ymin"][:, q] <= r) & (r <= e["ymax"][:, q])
        val = xat(q, r)
        idx = np.nonzero(inr)[0]
        xx[idx, j[idx]] = val[idx]
        j += inr
        dup = inr & (r == e["ymax"][:, q]) & (r < ymax)
        idx = np.nonzero(dup)[0]
        xx[idx, j[idx]] = val[idx]
        j += dup
        corner = (inr & ~dup & (dq != 0) & (j % 2 == 1)
                  & (np.floor(val) == val))
        if not corner.any():
            continue
        done = np.zeros(m, bool)
        a = xat(q, r + off)
        at_end = r == e["ymax"][:, q]
        for p in range(q):
            dp = e["dx"][:, p]
            skip = ((dq > 0) & (dp <= 0)) | ((dq < 0) & (dp >= 0))
            hit = corner & ~done & nonh[:, p] & ~skip & (val == xat(p, r))
            if not hit.any():
                continue
            b = xat(p, r + off)
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            new = np.where(at_end, np.where(dq > 0, hi + 1, lo - 1),
                           np.where(dq > 0, lo, hi + 1)).astype(_F32)
            idx = np.nonzero(hit)[0]
            xx[idx, tpos[idx, p]] = new[idx]
            done |= hit
    xx[np.arange(8)[None] >= j[:, None]] = np.inf
    xx.sort(axis=1)
    spans = []
    for i in range(1, 8, 2):
        ok = i < j
        xs = _round_up(np.where(ok, xx[:, i - 1], 0))
        xe = _round_down(np.where(ok, xx[:, i], 0))
        ok &= xe >= xs
        spans.append((r[ok], xs[ok], xe[ok]))
    return spans


def draw_wide_lines(canvas: np.ndarray, segments_px: np.ndarray,
                    ink: int) -> None:
    """``ImageDraw.line([(x1, y1), (x2, y2)], fill=ink, width=2)`` for
    each row of ``segments_px`` (L, 4) on an 8-bit (H, W) canvas, in
    place. Endpoints are truncated to integers as Pillow does."""
    h, w = canvas.shape
    x0, y0, x1, y1 = np.trunc(segments_px).astype(np.int64).T
    edges, point = _wide_line_edges(x0, y0, x1, y1)
    line = {k: v[~point] for k, v in edges.items()}
    horiz = line["horiz"]
    spans = _polygon_spans(line, h) + [
        (line["ymin"][horiz], line["xmin"][horiz], line["xmax"][horiz]),
        (y0[point], x0[point], x0[point])]
    ys, xs, xe = (np.concatenate(v) for v in zip(*spans))
    # hline8's clipping
    ok = (ys >= 0) & (ys < h) & (xs < w) & (xe >= 0)
    ys, xs, xe = ys[ok], np.maximum(xs[ok], 0), np.minimum(xe[ok], w - 1)
    ok = xs <= xe
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (ys[ok], xs[ok]), 1)
    np.add.at(diff, (ys[ok], xe[ok] + 1), -1)
    canvas[np.cumsum(diff, 1)[:, :w] > 0] = ink


def render_scene_image_wh(scene, width: int, height: int,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
    """Draw the scene's normalized-frame segments (centre origin, +y up,
    the long axis [-1, 1]) as dark 2-px lines on a light width x height
    background so a line detector can re-extract them; with ``rng``, add
    the JAX package's N(0, 3) sensor noise (one draw of height x width)."""
    s = _F32(max(width, height) / 2.0)
    cx, cy = _F32(width / 2.0), _F32(height / 2.0)
    seg = np.asarray(scene.segments, _F32)
    # pixel coordinates in float32, as numpy computes them from the
    # float32 segments in the JAX package's drawing loop
    px = np.stack([seg[:, 0] * s + cx, -seg[:, 1] * s + cy,
                   seg[:, 2] * s + cx, -seg[:, 3] * s + cy], 1)
    canvas = np.full((height, width), _PAPER, np.uint8)
    draw_wide_lines(canvas, px.astype(np.float64), _INK)
    arr = canvas.astype(np.float64)
    if rng is not None:
        arr = np.clip(arr + rng.normal(0, 3.0, arr.shape), 0, 255)
    return arr.astype(np.uint8)


def render_scene_image(scene, size: int = 640,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """The square case of :func:`render_scene_image_wh`."""
    return render_scene_image_wh(scene, size, size, rng)


def synthetic_records(count: int = 25, seed: int = 7,
                      size: int = 640) -> tuple[list[Record], int]:
    """The synthetic benchmark's records (same seed and draw order as the
    JAX package, so a seed gives the same scenes and images)."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(count):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 60)),
                                 outliers=int(rng.integers(5, 25)))
        img = render_scene_image(scene, size=size, rng=rng)
        records.append(Record(name=f"synthetic_{i:04d}", image=img,
                              true_horizon=scene.horizon.astype(np.float64)))
    return records, 0


# name -> (adapter, the size the images are resized to fit, or None)
DATASETS = {
    "york": (yud_records, None),
    "eurasian": (ecd_records, 800),
    "horizon": (hlw_records, 800),
    "synthetic": (synthetic_records, None),
}


def get_data_list(source_folder: str, destination_folder: str, name: str,
                  dataset_name: str | None = None,
                  distance_measure: str = "angle", use_weights: bool = True,
                  do_split: bool = True, do_merge: bool = True,
                  update: bool = False) -> dict:
    """The reference's manifest function: the EM configuration goes into the
    data set's name (configuration = cache identity), the image list is
    globbed by each data set's convention, and the manifest is kept as
    JSON and reused unless ``update``."""
    fullname = (f"{name}_{distance_measure}_"
                f"{'' if use_weights else 'no'}weights_"
                f"{'' if do_split else 'no'}split_"
                f"{'' if do_merge else 'no'}merge")
    manifest_path = os.path.join(destination_folder, f"{fullname}.json")
    if os.path.isfile(manifest_path) and not update:
        with open(manifest_path) as fh:
            return json.load(fh)

    if dataset_name == "york":
        image_files = glob.glob(os.path.join(source_folder, "P*", "P*.jpg"))
    elif dataset_name == "eurasian":
        image_files = glob.glob(os.path.join(source_folder, "*.jpg"))
    elif dataset_name == "horizon":
        with open(os.path.join(source_folder, "split", "test.txt")) as fh:
            image_files = [os.path.join(source_folder, "images", ln.strip())
                           for ln in fh if ln.strip()]
    else:
        image_files = []
        for ext in ("*.jpg", "*.png", "*.pgm"):
            image_files += glob.glob(os.path.join(source_folder, ext))
    image_files.sort()

    dest = os.path.join(destination_folder, fullname)
    dataset = {
        "source_folder": source_folder,
        "destination_folder": dest,
        "name": fullname,
        "distance_measure": distance_measure,
        "use_weights": use_weights,
        "do_split": do_split,
        "do_merge": do_merge,
        "image_files": image_files,
        "cache_files": [os.path.join(
            dest, os.path.splitext(os.path.basename(f))[0] + ".result.npz")
            for f in image_files],
    }
    os.makedirs(dest, exist_ok=True)
    with open(manifest_path, "w") as fh:
        json.dump(dataset, fh, indent=1)
    return dataset
