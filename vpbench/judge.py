"""The comparison that decides ``correct``.

Each stage of the program is judged by the plain reference
(``vpbench/reference``) run on that stage's own inputs, as the program
had them: the detector on the images, the renderer on the program's
segments, the CNN on the program's sphere images, the EM on the
program's lines, sphere images and grids, the horizon search on the
program's VPs. So a knife edge in one stage does not carry into the
next stage's number, and each number says which stage departed.

The numbers, each over the images judged:

* ``det_unmatched`` (image cells): the largest share, over images, of
  valid segments (of both sides) with no segment of the other side whose
  endpoints lie within ``seg_tol`` (either orientation);
* ``sphere_off``: the largest share, over images, of sphere-image pixels
  more than one grey level from the reference's;
* ``grid_err``: the largest absolute difference of a CNN grid cell;
* ``em_hz_off``: the share of images whose horizon, searched by the
  reference on the reference EM's VPs (the EM run on the program's
  lines, sphere images and grids), lies more than ``hz_tol`` from the
  program's (normalized horizon error): the EM's VPs, live slots and
  inlier counts judged by the answer they give. The VP sets themselves
  (``em_gap`` in the per-image readings: the largest sine from a live VP
  to the nearest live VP of the other side with an inlier count within
  ``count_tol``) part at the EM's knife edges on 10-35% of images between
  two sound float32 orders, too close to the control to hold a limit;
* ``hz_err``: the largest normalized horizon error between the program's
  horizon and the reference's search on the program's VPs.

A cell's ``vpbench/limits/<workload>.json`` gives the tolerances
(``check``) and each number's limit; a run is correct when no number
exceeds its limit (``run.verdict``: a NaN exceeds every limit).
"""

from __future__ import annotations

import math

import torch

from .reference.pipeline import Reference, horizon_error

NUMBERS = ("det_unmatched", "sphere_off", "grid_err", "em_hz_off", "hz_err")


def _segment_unmatched(lp_a, m_a, lp_b, m_b, tol: float) -> torch.Tensor:
    """Per image, the share of valid segments of a and b with no valid
    segment of the other side within ``tol`` (max endpoint coordinate
    gap, either orientation)."""
    a, b = lp_a.double(), lp_b.double()
    rev = b[..., [2, 3, 0, 1]]
    d = torch.minimum((a[:, :, None] - b[:, None]).abs().amax(-1),
                      (a[:, :, None] - rev[:, None]).abs().amax(-1))
    d = torch.where(torch.isnan(d), math.inf, d)
    pair = m_a[:, :, None] & m_b[:, None]
    d = torch.where(pair, d, math.inf)
    miss_a = m_a & ~(d.amin(2) <= tol)
    miss_b = m_b & ~(d.amin(1) <= tol)
    n = (m_a.sum(1) + m_b.sum(1)).clamp(min=1)
    return (miss_a.sum(1) + miss_b.sum(1)).double() / n


def _em_gap(vp_a, al_a, c_a, vp_b, al_b, c_b,
            count_tol: float) -> torch.Tensor:
    """Per image, the largest sine of the angle from a live VP of either
    side to the nearest live VP of the other whose inlier count is within
    ``count_tol`` (inf where none is, or where the numbers of live VPs
    differ)."""
    a, b = vp_a.double(), vp_b.double()
    a = a / a.norm(dim=-1, keepdim=True).clamp(min=1e-300)
    b = b / b.norm(dim=-1, keepdim=True).clamp(min=1e-300)
    sin = torch.linalg.cross(a[:, :, None].expand(-1, -1, b.shape[1], -1),
                             b[:, None].expand(-1, a.shape[1], -1, -1)
                             ).norm(dim=-1)
    ok = ((c_a[:, :, None].double() - c_b[:, None].double()).abs()
          <= count_tol) & al_a[:, :, None] & al_b[:, None]
    sin = torch.where(ok & ~torch.isnan(sin), sin, math.inf)
    gap_a = torch.where(al_a, sin.amin(2), 0.0).amax(1)
    gap_b = torch.where(al_b, sin.amin(1), 0.0).amax(1)
    gap = torch.maximum(gap_a, gap_b)
    return torch.where(al_a.sum(1) == al_b.sum(1), gap, math.inf)


def judge(ref: Reference, batches: list, outs: list, check: dict,
          width: int, height: int) -> tuple[dict, dict]:
    """Judge the program's outputs ``outs`` (one dict per batch) on their
    inputs ``batches`` -> (numbers by name, per-image readings for the
    record: each number's per-image values, concatenated)."""
    per = {k: [] for k in NUMBERS if k != "em_hz_off"} | {"em_gap": [],
                                                          "em_hz": []}
    for batch, out in zip(batches, outs):
        with torch.inference_mode():
            if "images" in batch:
                lp_r, m_r = ref.detect(batch["images"])
                per["det_unmatched"].append(_segment_unmatched(
                    out["segments"], out["segment_mask"], lp_r, m_r,
                    check["seg_tol"]))
                lp, lmask = out["segments"], out["segment_mask"]
                l = ref.lines(lp, lmask)
            else:
                l, lp, lmask = batch["l"], batch["lp"], batch["lmask"]
            sph = out["sphere_image"]
            d = (ref.sphere(l, lmask).int() - sph.int()).abs()
            per["sphere_off"].append((d > 1).double().mean((1, 2)))
            g = ref.grid(sph)
            per["grid_err"].append(
                (g.double() - out["cnn_prediction"].double()).abs()
                .amax((1, 2)).nan_to_num(math.inf))
            vp, alive, counts = ref.em(l, lp, out["cnn_prediction"], sph,
                                       lmask)
            per["em_gap"].append(_em_gap(
                out["vp"], out["alive"], out["counts"], vp, alive, counts,
                check["count_tol"]))
            hr1, hr2 = ref.horizon(vp, counts, alive)
            per["em_hz"].append(horizon_error(out["hp1"], out["hp2"], hr1,
                                              hr2, width, height))
            hp1, hp2 = ref.horizon(out["vp"], out["counts"], out["alive"])
            per["hz_err"].append(horizon_error(out["hp1"], out["hp2"], hp1,
                                               hp2, width, height))
    per = {k: torch.cat(v).cpu() for k, v in per.items() if v}
    numbers = {k: float(v.max()) for k, v in per.items()
               if k not in ("em_gap", "em_hz")}
    numbers["em_hz_off"] = float((~(per["em_hz"] <= check["hz_tol"]))
                                 .double().mean())
    numbers = {k: numbers[k] for k in NUMBERS if k in numbers}
    return numbers, {k: v.tolist() for k, v in per.items()}

