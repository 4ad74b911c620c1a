"""Per-stage times and the EM's host reads: a frozen copy of the port's
``bench.stage_pass`` and ``bench.host_reads``, taking the lines path too.

One batch runs through the same stages as the pipeline's entry, with a
synchronize after each stage, so a stage's time includes its queued
work. Those synchronizes are not in the timed path: stage times come
from passes of their own, after the window.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def host_reads(dev: torch.device):
    """Count the host's reads of the truth value of a tensor on ``dev``'s
    device type inside the block (on a GPU each is a device-to-host sync:
    the EM's loop conditions). ``.item()`` and ``.cpu()`` reads are not
    counted. Yields a dict whose ``"n"`` holds the count."""
    n = {"n": 0}
    orig = torch.Tensor.__bool__

    def counting(t):
        if t.device.type == dev.type:
            n["n"] += 1
        return orig(t)

    torch.Tensor.__bool__ = counting
    try:
        yield n
    finally:
        torch.Tensor.__bool__ = orig


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage_pass(host: dict, model, mean: torch.Tensor, cfg) -> tuple:
    """One batch (host tensors: ``images``, or ``l``, ``lp``, ``lmask``)
    through the pipeline's stages with a synchronize after each ->
    ({stage: seconds}, the EM's host reads). The EM and the horizon
    search run in the pipeline's fixed chunks."""
    from vanishing_points_2017_tpu_torch.batching import in_chunks
    from vanishing_points_2017_tpu_torch.em import (
        calculate_horizon_and_ortho_vp, expectation_maximisation)
    from vanishing_points_2017_tpu_torch.models import cnn as cnn_mod
    from vanishing_points_2017_tpu_torch.ops import lines as lineops
    from vanishing_points_2017_tpu_torch.ops import sphere
    from vanishing_points_2017_tpu_torch.ops.lines_device import \
        detect_segments_device

    dev = mean.device
    t = {}

    def mark(name, t0):
        _sync(dev)
        t[name] = time.perf_counter() - t0
        return time.perf_counter()

    with torch.inference_mode():
        t0 = time.perf_counter()
        dv = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
        t0 = mark("h2d", t0)
        if "images" in dv:
            lp, lmask = detect_segments_device(dv["images"],
                                               **cfg.det_kwargs())
            t0 = mark("detector", t0)
            l = torch.where(lmask[..., None],
                            lineops.segments_to_homogeneous(lp), 0.0)
        else:
            l, lp, lmask = dv["l"], dv["lp"], dv["lmask"]
        img_u8 = sphere.sphere_image_uint8(l, lmask, cfg.sphere_size)
        t0 = mark("render", t0)
        pred = model(cnn_mod.preprocess(img_u8, mean))
        t0 = mark("cnn", t0)
        with host_reads(dev) as reads:
            em = in_chunks(
                lambda *a: expectation_maximisation(*a, cfg.em),
                [l, lp, pred, img_u8.float(), lmask])
        t0 = mark("em", t0)
        in_chunks(lambda v, c, a: calculate_horizon_and_ortho_vp(
            v, c, a, maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
            pos_gate_ideal_tol=cfg.horizon_pos_gate_tol),
            [em.vp, em.counts, em.alive])
        mark("horizon", t0)
    return t, reads["n"]
