"""Synthetic Manhattan scenes (``models/synth.py`` of the JAX package).

A random camera rotation gives three orthogonal vanishing points; line
segments pass through them (up to noise), with outlier clutter; the
training scenes add a detector's artefacts, and ``vp_grid_label`` gives
the CNN's 20 x 20 target. Host-side
numpy on the caller's ``np.random.Generator``, drawing in the JAX
package's order, so a seed gives the identical scene in both packages.

Coordinates are the pipeline's: normalized image frame (centre origin, +y
up, long axis in [-1, 1]); VPs are unit 3-vectors with z >= 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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


def make_training_scene(rng: np.random.Generator) -> Scene:
    """Domain-randomized scene for CNN training: variable line counts and
    lengths, fragmented long segments, near-duplicate detections, dropped
    lines and endpoint noise up to ~1.5 px at 640, so the CNN sees a line
    detector's statistics rather than idealized segments."""
    scene = make_scene(rng,
                       lines_per_vp=int(rng.integers(12, 60)),
                       outliers=int(rng.integers(0, 30)),
                       noise=float(rng.uniform(0.001, 0.005)))
    seg = scene.segments.copy()
    assoc = scene.vp_assoc.copy()

    # global length scaling (detectors often return shorter fragments)
    scale = float(rng.uniform(0.5, 1.1))
    mids = 0.5 * (seg[:, 0:2] + seg[:, 2:4])
    seg[:, 0:2] = mids + (seg[:, 0:2] - mids) * scale
    seg[:, 2:4] = mids + (seg[:, 2:4] - mids) * scale

    # fragmentation: split some long segments in two with a small gap
    frag = rng.random(seg.shape[0]) < rng.uniform(0.0, 0.4)
    extra_s, extra_a = [], []
    for i in np.flatnonzero(frag):
        p1, p2 = seg[i, 0:2].copy(), seg[i, 2:4].copy()
        cut = rng.uniform(0.35, 0.65)
        gap = rng.uniform(0.01, 0.05)
        m = p1 + cut * (p2 - p1)
        d = (p2 - p1) / max(np.linalg.norm(p2 - p1), 1e-6)
        seg[i, 2:4] = m - 0.5 * gap * d
        extra_s.append(np.concatenate([m + 0.5 * gap * d, p2]))
        extra_a.append(assoc[i])

    # near-duplicates (parallel edge pairs ~1-2 px apart)
    dup = rng.random(seg.shape[0]) < rng.uniform(0.0, 0.3)
    for i in np.flatnonzero(dup):
        off = rng.normal(scale=0.004, size=2)
        extra_s.append(np.concatenate([seg[i, 0:2] + off, seg[i, 2:4] + off]))
        extra_a.append(assoc[i])

    if extra_s:
        seg = np.concatenate([seg, np.stack(extra_s)], axis=0)
        assoc = np.concatenate([assoc, np.array(extra_a)])

    # random dropout, unless it would leave fewer than 8 lines
    keep = rng.random(seg.shape[0]) >= rng.uniform(0.0, 0.35)
    if keep.sum() >= 8:
        seg, assoc = seg[keep], assoc[keep]

    return Scene(segments=seg.astype(np.float32),
                 lines=segments_to_lines(seg).astype(np.float32),
                 vps=scene.vps, vp_assoc=assoc, horizon=scene.horizon)


def vp_grid_label(vps: np.ndarray, grid: int = 20,
                  sigma_cells: float = 0.7) -> np.ndarray:
    """(grid, grid) training target: Gaussian bumps of peak 1 at the VPs'
    angle positions; cell (b, a) covers (alpha_a, beta_b)."""
    alphas = np.arcsin(np.clip(vps[:, 0] / np.cos(np.arcsin(
        np.clip(vps[:, 1], -1, 1))), -1, 1))
    betas = np.arcsin(np.clip(vps[:, 1], -1, 1))
    # fractional grid coordinates
    ga = (alphas / np.pi + 0.5) * grid - 0.5
    gb = (betas / np.pi + 0.5) * grid - 0.5
    bb, aa = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    label = np.zeros((grid, grid), np.float32)
    for k in range(vps.shape[0]):
        d2 = (aa - ga[k]) ** 2 + (bb - gb[k]) ** 2
        label = np.maximum(label, np.exp(-0.5 * d2 / sigma_cells ** 2))
    return label
