"""The reference's stages and the whole chain, in a stated precision.

``PRECISIONS["config"]`` is what the configurations state: the detector,
the renderer, the EM and the horizon search in float32 with TF32 off, the
CNN in bfloat16. ``PRECISIONS["control"]`` is one step below each: the
float32 stages without matrix products in bfloat16, the EM (whose
products are float32 with TF32 off) with TF32 on, the CNN in float8.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import cnn, detector, em, horizon, render
from .lines import segments_to_homogeneous

PRECISIONS = {
    "config": {"det": torch.float32, "render": torch.float32, "cnn": "bf16",
               "em_tf32": False, "horizon": torch.float32},
    "control": {"det": torch.bfloat16, "render": torch.bfloat16,
                "cnn": "fp8", "em_tf32": True, "horizon": torch.bfloat16},
}
# images per EM call on the card; on the CPU, where only the tests run,
# one at a time, as the port runs each image alone there
EM_BLOCK = 8


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Reference:
    """The reference for one configuration (its ``pipeline`` section), on
    the weights and mean that the benchmark hands to both sides."""

    def __init__(self, config: dict, params: dict, mean: torch.Tensor):
        self.cfg = config["pipeline"]
        self.params, self.mean = params, mean
        self.em_cfg = em.EMConfig(**self.cfg["em"])

    def detect(self, images, prec="config"):
        return detector.detect_segments(images, self.cfg["detector"],
                                        PRECISIONS[prec]["det"])

    @staticmethod
    def lines(lp, lmask):
        """Homogeneous lines of the segments, zero where masked."""
        return torch.where(lmask[..., None], segments_to_homogeneous(lp), 0.0)

    def sphere(self, l, lmask, prec="config"):
        return render.sphere_image_u8(l, lmask, self.cfg["sphere_size"],
                                      PRECISIONS[prec]["render"])

    def grid(self, sphere_u8, prec="config"):
        return cnn.grid(self.params, self.mean, sphere_u8,
                        PRECISIONS[prec]["cnn"])

    def horizon(self, vp, counts, alive, prec="config"):
        dt = PRECISIONS[prec]["horizon"]
        hz = self.cfg["horizon"]
        hp1, hp2, *_ = horizon.calculate_horizon_and_ortho_vp(
            vp.to(dt), counts.to(dt), alive, maxbest=hz["maxbest"],
            theta_vmin=hz["theta_vmin"],
            pos_gate_ideal_tol=hz["pos_gate_ideal_tol"])
        return hp1.float(), hp2.float()

    def em(self, l, lp, grid, sphere_u8, lmask, prec="config"):
        """The EM in blocks of :data:`EM_BLOCK` images -> (vp, alive,
        counts)."""
        outs = []
        block = EM_BLOCK if l.is_cuda else 1
        with _tf32(PRECISIONS[prec]["em_tf32"]):
            for i in range(0, l.shape[0], block):
                s = slice(i, i + block)
                r = em.expectation_maximisation(
                    l[s], lp[s], grid[s], sphere_u8[s].float(), lmask[s],
                    self.em_cfg)
                outs.append((r.vp, r.alive, r.counts))
        return tuple(torch.cat(z) for z in zip(*outs))

    @torch.inference_mode()
    def chain(self, batch: dict, prec: str) -> dict:
        """The whole pipeline on one batch (``images``, or ``l``, ``lp``,
        ``lmask``) -> the program's output keys."""
        out = {}
        if "images" in batch:
            lp, lmask = self.detect(batch["images"], prec)
            l = self.lines(lp, lmask)
            out.update(segments=lp, segment_mask=lmask)
        else:
            l, lp, lmask = batch["l"], batch["lp"], batch["lmask"]
        sph = self.sphere(l, lmask, prec)
        g = self.grid(sph, prec)
        vp, alive, counts = self.em(l, lp, g, sph, lmask, prec)
        hp1, hp2 = self.horizon(vp, counts, alive, prec)
        out.update(sphere_image=sph, cnn_prediction=g, vp=vp, alive=alive,
                   counts=counts, hp1=hp1, hp2=hp2)
        return out


def horizon_error(hp1a, hp2a, hp1b, hp2b, width: int, height: int):
    """Per image, the largest vertical gap between two horizons at x = +-1
    (the points hp1, hp2 (B, 3)), as a share of the image height (the
    2017 benchmark's normalized horizon error)."""
    def y(p):
        return (p[:, 1] / p[:, 2]).double()

    gap = torch.maximum((y(hp1a) - y(hp1b)).abs(), (y(hp2a) - y(hp2b)).abs())
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    return gap / 2.0 * max(width, height) / height
