"""Reference-shaped result contracts (``em/compat.py`` of the JAX package).

The EM core returns masked fixed-slot tensors with a batch dimension; the
2017 reference returns compact arrays keyed as its ``vp_localisation.py``
does. This module converts between the two and offers the reference's
one-image entry points (``run_em_single``, ``create_data_dict_single``,
``renew_cnn_result``, ``save_cnn_result``) over the port's batched
functions at B = 1, for users who come from the reference. Inputs and
outputs are numpy; the work runs on ``device`` (the GPU unless the caller
names another, where the sphere images go through the render kernel).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import require_device
from ..models import cnn as cnn_mod
from ..ops import probability as prob
from ..ops.sphere import sphere_image_uint8
from .em import EMConfig, EMResult, expectation_maximisation


class PDF(NamedTuple):
    """The reference's E-step bundle (``PDF = namedtuple('PDF', 'v lv vl l
    lvsq angles')``): compact arrays, linear float64 probabilities."""

    v: np.ndarray       # (M,) prior at the VPs
    lv: np.ndarray      # (N, M) likelihood p(l|v)
    vl: np.ndarray      # (M, N) posterior p(v|l)
    l: np.ndarray       # (N,) evidence p(l), floored at 1e-12
    lvsq: np.ndarray    # (N, M) squared line-VP inconsistency
    angles: np.ndarray  # (M, 2) VP angles


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _final_distribution(res: EMResult, l, lp, lmask, cnn_prediction,
                        cfg: EMConfig, n: int) -> PDF:
    """The E-step at the final VP state of a B = 1 result: the reference
    returns its last ``p`` bundle as ``'distribution'``. Made linear in
    float64 on the host (log p(l|v) can exceed float32's range, like the
    reference's 1/sqrt(2 pi s) factors)."""
    p = prob.calc_probabilities(
        prob.pdf_params(cnn_prediction), res.vp, res.alive, l, lp,
        res.log_sigma, lmask, cfg.distance_measure, cfg.wrap_quirk)
    alive = res.alive[0].cpu().numpy().astype(bool)
    return PDF(
        v=_np64(p.p_v[0])[alive],
        lv=np.exp(_np64(p.log_plv[0])[:n][:, alive]),
        vl=_np64(p.p_vl[0])[alive][:, :n],
        l=np.exp(_np64(p.log_pl[0]))[:n],
        lvsq=_np64(p.lvsq[0])[:n][:, alive],
        angles=_np64(p.angles[0])[alive],
    )


def em_result_to_dict(res: EMResult, distribution: PDF | None = None) -> dict:
    """One image's masked slots (an :class:`EMResult` without the batch
    dimension) -> the reference's compact result dict. VP slot indices in
    ``vp_assoc`` are renumbered to the compact order, outliers stay -1. An
    invalid result maps to the reference's empty dict."""
    if not bool(res.valid):
        return {"vp_assoc": None, "vp": None, "counts": None,
                "count_id": None, "decision_metric": None, "iterations": 0,
                "distribution": None}

    def host(t):
        return torch.as_tensor(t).detach().cpu().numpy()

    alive = host(res.alive).astype(bool)
    slots = np.flatnonzero(alive)
    renumber = np.full(alive.shape[0], -1, np.int64)
    renumber[slots] = np.arange(slots.shape[0])
    assoc = host(res.vp_assoc)
    return {
        "vp": host(res.vp)[alive],
        "vp_assoc": np.where(assoc >= 0, renumber[np.clip(assoc, 0, None)],
                             -1),
        "counts": host(res.counts)[alive],
        "counts_weighted": host(res.counts_weighted)[alive],
        "count_id": None,
        "decision_metric": host(res.decision_metric)[alive],
        "sigma": np.exp(host(res.log_sigma))[alive],
        "iterations": int(res.iterations),
        "distribution": distribution,
    }


def _padded_lines(lines: np.ndarray, n_pad: int, device: torch.device):
    """(N, 3) lines -> (1, n_pad, 3) float32 and (1, n_pad) mask tensors."""
    n = lines.shape[0]
    l = np.zeros((n_pad, 3), np.float32)
    l[:n] = np.asarray(lines)[:, :3]
    return (torch.from_numpy(l)[None].to(device),
            torch.from_numpy(np.arange(n_pad) < n)[None].to(device))


@torch.inference_mode()
def run_em_single(lines: np.ndarray, line_segments: np.ndarray,
                  cnn_prediction: np.ndarray, sphere_image: np.ndarray,
                  distance_measure: str = "angle", use_weights: bool = True,
                  do_split: bool = True, do_merge: bool = True,
                  n_pad: int = 512,
                  device: str | torch.device = "cuda") -> dict:
    """The reference's one-image EM: compact dict out.

    lines (N, 3) and line_segments (N, 4) in the normalized frame,
    cnn_prediction (20, 20), sphere_image (S, S) in Agg orientation."""
    device = require_device(device)
    cfg = EMConfig(distance_measure=distance_measure,
                   use_weights=use_weights, do_split=do_split,
                   do_merge=do_merge)
    n = lines.shape[0]
    if n > n_pad:
        raise ValueError(f"{n} lines exceed the n_pad bucket {n_pad}")
    l, lmask = _padded_lines(lines, n_pad, device)
    lp = np.zeros((n_pad, 4), np.float32)
    lp[:n] = line_segments[:, :4]
    lp = torch.from_numpy(lp)[None].to(device)
    pred = torch.as_tensor(np.asarray(cnn_prediction, np.float32))[None].to(
        device)
    img = torch.as_tensor(np.asarray(sphere_image, np.float32))[None].to(
        device)
    res = expectation_maximisation(l, lp, pred, img, lmask, cfg)
    dist = (_final_distribution(res, l, lp, lmask, pred, cfg, n)
            if bool(res.valid[0]) else None)
    out = em_result_to_dict(EMResult(*(f[0] for f in res)),
                            distribution=dist)
    if out["vp_assoc"] is not None:
        out["vp_assoc"] = out["vp_assoc"][:n]
    return out


def create_data_dict_single(image_rgb: np.ndarray,
                            cnn_input_size: int = 250, n_pad: int = 512,
                            device: str | torch.device = "cuda") -> dict:
    """The reference's in-memory one-image ingest: grayscale -> LSD ->
    homogeneous lines -> sphere image, returned in its
    ``{'lines': datum, 'sphere_image': image}`` shape (no disk I/O)."""
    from ..data import io as dio
    from ..pipeline import pad_lines

    device = require_device(device)
    gray = dio.rgb2gray(image_rgb)
    datum = {"image_shape": gray.shape, "image": image_rgb}
    segments = dio.detect_lsd_lines(gray)["segments"]
    lines = np.zeros((segments.shape[0], 3))
    if segments.shape[0]:
        ones = np.ones((segments.shape[0], 1))
        lines = np.cross(np.concatenate([segments[:, 0:2], ones], axis=1),
                         np.concatenate([segments[:, 2:4], ones], axis=1))
    datum["line_segments"] = segments
    datum["lines"] = lines

    l, _, lmask = pad_lines(segments, n_pad)
    img = sphere_image_uint8(torch.from_numpy(l)[None].to(device),
                             torch.from_numpy(lmask)[None].to(device),
                             size=cnn_input_size)
    return {"lines": datum, "sphere_image": img[0].cpu().numpy()}


@torch.inference_mode()
def _cnn_prediction(params: dict, mean, img_u8: torch.Tensor) -> np.ndarray:
    """The float32 CNN on one uint8 sphere image (1, S, S) -> (20, 20)."""
    dev = img_u8.device
    params = {k: {kk: vv.to(dev) for kk, vv in d.items()}
              for k, d in params.items()}
    mean = torch.as_tensor(mean, dtype=torch.float32).to(dev)
    model = cnn_mod.VPNet(params, compute_dtype=torch.float32).eval()
    return model(cnn_mod.preprocess(img_u8, mean))[0].cpu().numpy()


def renew_cnn_result(params: dict, mean, lines: np.ndarray,
                     image_size: int = 500,
                     device: str | torch.device = "cuda"):
    """Render the sphere image from ``lines`` again and run the CNN again
    (the reference's ``renew_cnn_result``), for callers that changed the
    line set after the CNN pass. ``params``: this port's layout
    (``weights.load_params_and_mean``). lines: (N, 3) homogeneous lines in
    the normalized frame. Returns ``(sphere_image, prediction)``."""
    device = require_device(device)
    n = np.asarray(lines).shape[0]
    n_pad = max(512, int(2 ** np.ceil(np.log2(max(n, 1)))))
    img = sphere_image_uint8(*_padded_lines(np.asarray(lines), n_pad, device),
                             size=image_size)
    return img[0].cpu().numpy(), _cnn_prediction(params, mean, img)


def save_cnn_result(params: dict, mean, datum: dict, file_for_basename: str,
                    sphere_size: int = 500, n_pad: int = 512,
                    device: str | torch.device = "cuda") -> str:
    """The CNN on a datum's sphere image, kept in the datum and on disk
    (the reference's ``save_cnn_result``; npz instead of pickle). Returns
    the written path."""
    from ..pipeline import pad_lines

    device = require_device(device)
    l, _, lmask = pad_lines(np.asarray(datum["line_segments"]), n_pad)
    img = sphere_image_uint8(torch.from_numpy(l)[None].to(device),
                             torch.from_numpy(lmask)[None].to(device),
                             size=sphere_size)
    datum["prediction"] = _cnn_prediction(params, mean, img)
    out_path = f"{os.path.splitext(file_for_basename)[0]}.cnn_result.npz"
    np.savez(out_path, prediction=datum["prediction"],
             line_segments=np.asarray(datum["line_segments"]))
    return out_path
