"""Dataset adapters (``data/datasets.py`` of the JAX package): the
synthetic benchmark only.

The synthetic set draws random Manhattan scenes (``models/synth.py``) and
renders their segments as dark 2-px lines on a light background, with
mild sensor noise, so the host LSD and the on-device detector can
re-extract them; the ground-truth horizon is exact. The JAX package draws
with PIL's ``ImageDraw.line(width=2)``; the port does not use PIL, so
:func:`render_scene_image` reproduces that drawing pixel for pixel
(Pillow's ``ImagingDrawWideLine`` and its scanline polygon fill) in
numpy, and keeps the generator's stream in step with the JAX package's.

YUD, ECD and HLW need a JPEG decoder the port does not have yet
(ROADMAP.md): asking for them raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models import synth

LINE_WIDTH = 2
_INK, _PAPER = 40, 220
_F32 = np.float32


@dataclasses.dataclass
class Record:
    name: str
    image_path: str | None = None
    image: np.ndarray | None = None  # inline image (synthetic)
    true_horizon: np.ndarray | None = None  # normalized homogeneous line


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


def render_scene_image(scene, size: int = 640,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Draw the scene's segments as dark 2-px lines on a light background
    so a line detector can re-extract them; with ``rng``, add the JAX
    package's N(0, 3) sensor noise (one draw of size x size)."""
    s = _F32(size / 2.0)
    seg = np.asarray(scene.segments, _F32)
    # pixel coordinates in float32, as numpy computes them from the
    # float32 segments in the JAX package's drawing loop
    px = np.stack([seg[:, 0] * s + s, -seg[:, 1] * s + s,
                   seg[:, 2] * s + s, -seg[:, 3] * s + s], 1)
    canvas = np.full((size, size), _PAPER, np.uint8)
    draw_wide_lines(canvas, px.astype(np.float64), _INK)
    arr = canvas.astype(np.float64)
    if rng is not None:
        arr = np.clip(arr + rng.normal(0, 3.0, arr.shape), 0, 255)
    return arr.astype(np.uint8)


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


DATASETS = {"synthetic": (synthetic_records, None)}
