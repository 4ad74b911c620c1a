"""The traffic generator: synthetic Manhattan scenes drawn from a seed.

The scenes' geometry is a frozen copy of the port's scene generator
(``models/synth.make_scene`` and ``pipeline.pad_lines``), so that later
changes to the port cannot move the inputs the benchmark measures on:
for the same generator state it draws the port's segments byte for byte
(``vpbench/tests/test_vpbench_inputs.py``). :func:`draw_pool` draws a
cell's whole pool from ``--seed``: per scene, from ``default_rng(seed)``,
its line and outlier counts and then the scene, as ``bench.make_inputs``
draws them (without that function's host noise draw between scenes, so
only the first scene of seed 0 is one of its scenes). An image cell's
scenes are drawn on the device: each valid segment as a 2-px dark line
on a light background (:func:`rasterize`), plus N(0, ``noise_sigma``)
sensor noise from a ``torch.Generator`` seeded with ``--seed``, a chunk
of images at a time, into pinned host memory. A pool of a hundred
batches or more would take minutes to draw with the port's Pillow-exact
host renderer.

A traffic file (``vpbench/traffic/<name>.json``) holds the parameters:
``inputs`` ("images" or "lines"), ``batch``, ``pool`` (distinct batches
the window cycles through), ``judged`` (pool batches whose outputs the
reference judges), ``lines_per_vp`` and ``outliers`` (the half-open
integer ranges each scene's counts are drawn from), ``noise_sigma`` (the
sensor noise, grey levels) and ``n_pad`` (segment slots). The image size
is the configuration's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INK, PAPER = 40, 220
RENDER_CHUNK = 64    # images rasterized per call


@dataclasses.dataclass
class Scene:
    segments: np.ndarray   # (N, 4) normalized endpoints
    lines: np.ndarray      # (N, 3) homogeneous lines p1 x p2
    vps: np.ndarray        # (K, 3) unit hemisphere VPs (z >= 0)
    vp_assoc: np.ndarray   # (N,) index into vps, -1 for outliers
    horizon: np.ndarray    # (3,) horizon line = cross of the 2 horizontal VPs


def random_rotation(rng: np.random.Generator, max_roll: float = 0.12,
                    max_pitch: float = 0.45) -> np.ndarray:
    """Camera rotation with bounded roll and pitch and uniform yaw."""
    yaw = rng.uniform(-np.pi, np.pi)
    pitch = rng.uniform(-max_pitch, max_pitch)
    roll = rng.uniform(-max_roll, max_roll)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    r_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    r_roll = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return r_roll @ r_pitch @ r_yaw


def manhattan_vps(rotation: np.ndarray) -> np.ndarray:
    """(3, 3) unit hemisphere VPs of the world x, y (zenith) and z axes."""
    vps = (rotation @ np.eye(3)).T.copy()
    sign = np.sign(vps[:, 2])
    sign[sign == 0] = 1.0
    return vps * sign[:, None]


def segments_for_vp(rng: np.random.Generator, vp: np.ndarray, count: int,
                    min_len: float = 0.05, max_len: float = 0.35,
                    noise: float = 0.003) -> np.ndarray:
    """Segments whose supporting lines pass (up to noise) through the VP."""
    anchors = rng.uniform(-0.95, 0.95, size=(count, 2))
    if abs(vp[2]) > 1e-6:
        d = (vp[0:2] / vp[2])[None, :] - anchors
    else:
        d = np.broadcast_to(vp[0:2], (count, 2)).copy()
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    d = d / norm
    half = rng.uniform(min_len / 2, max_len / 2, size=(count, 1))
    seg = np.concatenate([anchors + half * d, anchors - half * d], axis=1)
    seg += rng.normal(scale=noise, size=seg.shape)
    return seg


def random_outliers(rng: np.random.Generator, count: int,
                    min_len: float = 0.05, max_len: float = 0.35) -> np.ndarray:
    anchors = rng.uniform(-0.95, 0.95, size=(count, 2))
    theta = rng.uniform(0, np.pi, size=(count, 1))
    d = np.concatenate([np.cos(theta), np.sin(theta)], axis=1)
    half = rng.uniform(min_len / 2, max_len / 2, size=(count, 1))
    return np.concatenate([anchors + half * d, anchors - half * d], axis=1)


def segments_to_lines(seg: np.ndarray) -> np.ndarray:
    p1 = np.concatenate([seg[:, 0:2], np.ones((seg.shape[0], 1))], axis=1)
    p2 = np.concatenate([seg[:, 2:4], np.ones((seg.shape[0], 1))], axis=1)
    return np.cross(p1, p2)


def make_scene(rng: np.random.Generator, lines_per_vp: int = 40,
               outliers: int = 15, noise: float = 0.003,
               max_pitch: float = 0.45) -> Scene:
    """A full Manhattan scene: 3 orthogonal VPs + outlier clutter."""
    vps = manhattan_vps(random_rotation(rng, max_pitch=max_pitch))
    segs, assoc = [], []
    for k in range(3):
        # fewer lines for the more oblique axes, like real facades
        n_k = max(4, int(lines_per_vp * rng.uniform(0.5, 1.0)))
        segs.append(segments_for_vp(rng, vps[k], n_k, noise=noise))
        assoc.append(np.full(n_k, k))
    if outliers:
        segs.append(random_outliers(rng, outliers))
        assoc.append(np.full(outliers, -1))
    seg = np.concatenate(segs, axis=0)
    assoc = np.concatenate(assoc, axis=0)
    perm = rng.permutation(seg.shape[0])
    seg, assoc = seg[perm], assoc[perm]

    # horizon through the two horizontal (non-zenith) VPs
    zenith_idx = int(np.argmax(np.abs(vps[:, 1])))
    hor = [i for i in range(3) if i != zenith_idx]
    horizon = np.cross(vps[hor[0]] / vps[hor[0], 2],
                       vps[hor[1]] / vps[hor[1], 2])
    return Scene(segments=seg.astype(np.float32),
                 lines=segments_to_lines(seg).astype(np.float32),
                 vps=vps.astype(np.float32), vp_assoc=assoc,
                 horizon=horizon.astype(np.float32))


def pad_lines(segments: np.ndarray, n_pad: int):
    """Normalized segments (n, 4) -> padded (l, lp, lmask) numpy arrays.

    Keeps the n_pad longest when n > n_pad (the scenes here have at most
    209 segments, so a 512-slot cell never truncates)."""
    n = segments.shape[0]
    if n > n_pad:
        length = np.hypot(segments[:, 0] - segments[:, 2],
                          segments[:, 1] - segments[:, 3])
        segments = segments[np.sort(np.argsort(-length)[:n_pad])]
        n = n_pad
    lp = np.zeros((n_pad, 4), np.float32)
    lp[:n] = segments[:, :4]
    p1 = np.concatenate([lp[:n, 0:2], np.ones((n, 1), np.float32)], axis=1)
    p2 = np.concatenate([lp[:n, 2:4], np.ones((n, 1), np.float32)], axis=1)
    l = np.zeros((n_pad, 3), np.float32)
    l[:n] = np.cross(p1, p2)
    return l, lp, np.arange(n_pad) < n


def rasterize(lp: torch.Tensor, lmask: torch.Tensor, height: int,
              width: int) -> torch.Tensor:
    """Normalized segments lp (S, N, 4) (centre origin, +y up, the long
    axis [-1, 1]) with their mask (S, N) -> (S, height, width) uint8
    canvases: ``PAPER``, each valid segment drawn in ``INK`` 2 px wide.
    The endpoints are truncated to whole pixels, as Pillow does; each
    segment is stepped one pixel at a time along its major axis, inking
    the pixel nearest the line and the next one across the minor axis,
    about the pixels of Pillow's ``ImageDraw.line(..., width=2)``."""
    dev = lp.device
    s = max(width, height) / 2.0
    img, seg = torch.nonzero(lmask, as_tuple=True)
    p = lp[img, seg].float()
    x0 = torch.trunc(p[:, 0] * s + width / 2.0)
    y0 = torch.trunc(-p[:, 1] * s + height / 2.0)
    dx = torch.trunc(p[:, 2] * s + width / 2.0) - x0
    dy = torch.trunc(-p[:, 3] * s + height / 2.0) - y0
    steps = torch.maximum(dx.abs(), dy.abs())
    k = int(steps.max()) + 1 if len(p) else 1
    t = (torch.arange(k, device=dev).float()[None]
         / steps.clamp(min=1)[:, None]).clamp(max=1.0)
    px = x0[:, None] + t * dx[:, None]
    py = y0[:, None] + t * dy[:, None]
    flat_x = (dx.abs() >= dy.abs())[:, None]
    canvas = torch.full((lmask.shape[0], height, width), PAPER,
                        dtype=torch.uint8, device=dev)
    for across in (0, 1):
        ix = torch.floor(px + 0.5).long() + torch.where(flat_x, 0, across)
        iy = torch.floor(py + 0.5).long() + torch.where(flat_x, across, 0)
        ok = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        flat = (img[:, None] * height + iy) * width + ix
        canvas.view(-1)[flat[ok]] = INK
    return canvas


@dataclasses.dataclass
class Pool:
    """A cell's inputs, host tensors (pinned when drawn for a card):
    ``images`` (P, B, H, W) uint8 or None, and the scenes' padded segments
    ``l`` (P, B, N, 3), ``lp`` (P, B, N, 4) and ``lmask`` (P, B, N)."""

    images: torch.Tensor | None
    l: torch.Tensor
    lp: torch.Tensor
    lmask: torch.Tensor

    def batch(self, k: int) -> dict:
        """Pool batch ``k`` as the entry takes it."""
        if self.images is not None:
            return {"images": self.images[k]}
        return {"l": self.l[k], "lp": self.lp[k], "lmask": self.lmask[k]}


def draw_scenes(traffic: dict, n: int, seed: int) -> tuple:
    """``n`` scenes from ``default_rng(seed)`` -> their padded (l, lp,
    lmask) numpy arrays, (n, N, ...)."""
    rng = np.random.default_rng(seed)
    lo_v, hi_v = traffic["lines_per_vp"]
    lo_o, hi_o = traffic["outliers"]
    ls, lps, masks = [], [], []
    for _ in range(n):
        scene = make_scene(rng, lines_per_vp=int(rng.integers(lo_v, hi_v)),
                           outliers=int(rng.integers(lo_o, hi_o)))
        l, lp, m = pad_lines(scene.segments, traffic["n_pad"])
        ls.append(l), lps.append(lp), masks.append(m)
    return np.stack(ls), np.stack(lps), np.stack(masks)


def draw_pool(traffic: dict, width: int, height: int, seed: int,
              device="cpu") -> Pool:
    """The cell's pool of ``traffic["pool"]`` batches of
    ``traffic["batch"]`` scenes drawn from ``seed``, an image cell's
    rasterized and noised on ``device`` (pinned on the host where that is
    a card)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    shape = (traffic["pool"], traffic["batch"])
    n = shape[0] * shape[1]
    arrays = draw_scenes(traffic, n, seed)
    l, lp, lmask = (torch.from_numpy(a).reshape(*shape, *a.shape[1:])
                    for a in arrays)
    if pin:
        l, lp, lmask = l.pin_memory(), lp.pin_memory(), lmask.pin_memory()
    if traffic["inputs"] != "images":
        return Pool(None, l, lp, lmask)
    images = torch.empty((n, height, width), dtype=torch.uint8,
                         pin_memory=pin)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lp_all, m_all = lp.reshape(n, *lp.shape[2:]), lmask.reshape(n, -1)
    for i in range(0, n, RENDER_CHUNK):
        j = min(n, i + RENDER_CHUNK)
        canvas = rasterize(lp_all[i:j].to(device), m_all[i:j].to(device),
                           height, width)
        noise = torch.randn(canvas.shape, generator=gen, device=device)
        img = (canvas.float() + traffic["noise_sigma"] * noise).clamp_(0, 255)
        images[i:j].copy_(img.to(torch.uint8))
    return Pool(images.reshape(*shape, height, width), l, lp, lmask)
