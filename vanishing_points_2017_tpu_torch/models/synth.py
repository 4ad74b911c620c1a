"""Synthetic Manhattan scenes (``models/synth.py`` of the JAX package).

A random camera rotation gives three orthogonal vanishing points; line
segments pass through them (up to noise), with outlier clutter. Host-side
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
