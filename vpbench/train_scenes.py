"""The training cells' traffic: batches of synthetic training scenes drawn
from a seed, as padded lines, their mask and the CNN's 20 x 20 labels.

The scenes are a frozen copy of the port's training-scene generator
(``models/synth.make_training_scene`` and ``vp_grid_label``, on
``vpbench/scenes.make_scene``, serving's frozen copy of
``synth.make_scene``), so that later changes to the port cannot move the
inputs the benchmark measures on: for the same generator state it draws
the port's scenes and labels byte for byte
(``vpbench/tests/test_vpbench_train.py``). :func:`draw_pool` draws a
cell's whole pool from ``default_rng(seed)``, scene after scene, and cuts
each to its first ``n_pad`` lines, as the port's
``models/train.draw_batch`` does.

A training traffic file (``vpbench/traffic/<name>.json``) holds
``"job": "train"``, ``batch`` (scenes per step), ``pool`` (distinct
batches the window cycles through), ``judged`` (steps whose state,
outputs and update the reference judges) and ``n_pad`` (line slots).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scenes import Scene, make_scene, segments_to_lines

GRID = 20


def make_training_scene(rng: np.random.Generator) -> Scene:
    """Domain-randomized scene for CNN training: variable line counts and
    lengths, fragmented long segments, near-duplicate detections, dropped
    lines and endpoint noise up to ~1.5 px at 640."""
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


def vp_grid_label(vps: np.ndarray, grid: int = GRID,
                  sigma_cells: float = 0.7) -> np.ndarray:
    """(grid, grid) training target: Gaussian bumps of peak 1 at the VPs'
    angle positions; cell (b, a) covers (alpha_a, beta_b)."""
    alphas = np.arcsin(np.clip(vps[:, 0] / np.cos(np.arcsin(
        np.clip(vps[:, 1], -1, 1))), -1, 1))
    betas = np.arcsin(np.clip(vps[:, 1], -1, 1))
    ga = (alphas / np.pi + 0.5) * grid - 0.5
    gb = (betas / np.pi + 0.5) * grid - 0.5
    bb, aa = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    label = np.zeros((grid, grid), np.float32)
    for k in range(vps.shape[0]):
        d2 = (aa - ga[k]) ** 2 + (bb - gb[k]) ** 2
        label = np.maximum(label, np.exp(-0.5 * d2 / sigma_cells ** 2))
    return label


@dataclasses.dataclass
class Pool:
    """A training cell's inputs, host tensors (pinned when drawn for a
    card): ``l`` (P, B, N, 3) float32 lines, ``lmask`` (P, B, N) bool and
    ``labels`` (P, B, 20, 20) float32."""

    l: torch.Tensor
    lmask: torch.Tensor
    labels: torch.Tensor

    def batch(self, k: int) -> tuple:
        """Pool batch ``k``: (lines, mask, labels)."""
        return self.l[k], self.lmask[k], self.labels[k]


def draw_pool(traffic: dict, seed: int, pin: bool = False) -> Pool:
    """The cell's pool of ``traffic["pool"]`` batches of
    ``traffic["batch"]`` training scenes from ``default_rng(seed)``."""
    shape = (traffic["pool"], traffic["batch"])
    n, n_pad = shape[0] * shape[1], traffic["n_pad"]
    rng = np.random.default_rng(seed)
    ls = np.zeros((n, n_pad, 3), np.float32)
    masks = np.zeros((n, n_pad), bool)
    labels = np.zeros((n, GRID, GRID), np.float32)
    for i in range(n):
        scene = make_training_scene(rng)
        m = min(scene.lines.shape[0], n_pad)
        ls[i, :m] = scene.lines[:m]
        masks[i, :m] = True
        labels[i] = vp_grid_label(scene.vps)
    out = [torch.from_numpy(a).reshape(*shape, *a.shape[1:])
           for a in (ls, masks, labels)]
    if pin:
        out = [t.pin_memory() for t in out]
    return Pool(*out)
