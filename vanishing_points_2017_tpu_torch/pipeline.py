"""End-to-end pipeline: grayscale image -> lines -> sphere -> CNN -> EM ->
horizon (``pipeline.py`` of the JAX package), on one device.

:func:`device_pipeline_full` is the zero-host-round-trip path: a batch of
uint8 grayscale images goes through the on-device detector, the sphere
renderer, the CNN, the EM and the horizon search without leaving the
device (the EM's loop conditions are the only device-to-host reads).
:func:`device_pipeline_batch` is the same chain from given padded lines.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .data import io as dio
from .em import EMConfig, expectation_maximisation
from .em.horizon import calculate_horizon_and_ortho_vp
from .models import cnn as cnn_mod
from .ops import lines as lineops
from .ops import sphere as sphere_mod
from .ops.lines_device import detect_segments_device
from .weights import params_from_numpy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The JAX package's defaults. The detector runs its global, exact
    top-k selection; the renderer is the kernel (CUDA) or its twin (CPU)."""

    sphere_size: int = 500
    n_pad: int = 512
    em: EMConfig = EMConfig()
    maxbest: int = 20
    theta_vmin: float = float(np.pi / 10)
    # zenith side-gate waiver for near-ideal vertical VPs (see the JAX
    # package's PipelineConfig); inf restores exact reference gating
    horizon_pos_gate_tol: float = 8.0
    cnn_dtype: str = "bfloat16"
    det_min_count: int = 15
    det_min_len_px: float = 12.0
    det_min_density: float = 0.7
    det_max_records: int = 32768

    def __post_init__(self):
        if self.cnn_dtype not in _DTYPES:
            raise ValueError(f"cnn_dtype {self.cnn_dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")


def pad_lines(segments: np.ndarray, n_pad: int):
    """Normalized segments (n, 4) -> padded (l, lp, lmask) numpy arrays,
    keeping the n_pad longest when n > n_pad."""
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


def build_model(params: dict, cfg: PipelineConfig) -> cnn_mod.VPNet:
    return cnn_mod.VPNet(params, compute_dtype=_DTYPES[cfg.cnn_dtype]).eval()


@torch.inference_mode()
def device_pipeline_batch(l: torch.Tensor, lp: torch.Tensor,
                          lmask: torch.Tensor, model: cnn_mod.VPNet,
                          mean: torch.Tensor, cfg: PipelineConfig) -> dict:
    """Render -> CNN -> EM -> horizon on padded lines: l (B, N, 3),
    lp (B, N, 4), lmask (B, N) bool. Returns a dict of (B, ...) tensors."""
    img_u8 = sphere_mod.sphere_image_uint8(l, lmask, size=cfg.sphere_size)
    pred = model(cnn_mod.preprocess(img_u8, mean))
    em = expectation_maximisation(l, lp, pred, img_u8.to(torch.float32),
                                  lmask, cfg.em)
    hp1, hp2, z_vp, h_vp1, h_vp2, combo = calculate_horizon_and_ortho_vp(
        em.vp, em.counts, em.alive, maxbest=cfg.maxbest,
        theta_vmin=cfg.theta_vmin, pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    return {
        "sphere_image": img_u8, "cnn_prediction": pred,
        "vp": em.vp, "alive": em.alive, "counts": em.counts,
        "counts_weighted": em.counts_weighted, "vp_assoc": em.vp_assoc,
        "iterations": em.iterations, "em_valid": em.valid,
        "hp1": hp1, "hp2": hp2, "zenith_vp": z_vp,
        "horizon_vp1": h_vp1, "horizon_vp2": h_vp2, "best_combo": combo,
    }


def device_pipeline(l, lp, lmask, model, mean, cfg: PipelineConfig) -> dict:
    """One image's padded lines (N, ...) -> outputs without a batch dim."""
    out = device_pipeline_batch(l[None], lp[None], lmask[None], model, mean,
                                cfg)
    return {k: v[0] for k, v in out.items()}


@torch.inference_mode()
def device_pipeline_full(images: torch.Tensor, model: cnn_mod.VPNet,
                         mean: torch.Tensor, cfg: PipelineConfig) -> dict:
    """Grayscale images (B, H, W) in [0, 255] -> full pipeline outputs,
    with the on-device detector in front of :func:`device_pipeline_batch`
    (its outputs plus ``segments`` and ``segment_mask``)."""
    lp, lmask = detect_segments_device(
        images, max_segments=cfg.n_pad, min_count=cfg.det_min_count,
        min_len_px=cfg.det_min_len_px, min_density=cfg.det_min_density,
        max_records=cfg.det_max_records)
    l = torch.where(lmask[..., None], lineops.segments_to_homogeneous(lp), 0.0)
    out = device_pipeline_batch(l, lp, lmask, model, mean, cfg)
    out.update(segments=lp, segment_mask=lmask)
    return out


class Pipeline:
    """Host orchestration around the device program. ``params``: this
    port's layout (``weights.load_params_and_mean``); None = random init
    from ``rng_seed``."""

    def __init__(self, params: dict | None = None,
                 mean: np.ndarray | torch.Tensor | None = None,
                 cfg: PipelineConfig = PipelineConfig(), rng_seed: int = 0,
                 device: str | torch.device = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = params_from_numpy(
                cnn_mod.init_params(rng_seed, input_size=cfg.sphere_size))
        params = {k: {kk: vv.to(self.device) for kk, vv in d.items()}
                  for k, d in params.items()}
        self.model = build_model(params, cfg)
        if mean is None:
            mean = np.zeros((cfg.sphere_size, cfg.sphere_size), np.float32)
        self.mean = torch.as_tensor(mean, dtype=torch.float32).to(self.device)

    @staticmethod
    def ingest_image(image: np.ndarray | str) -> dict:
        """Load + grayscale only (detection runs on the device)."""
        if isinstance(image, str):
            image = dio.load_image(image)
        gray = dio.rgb2gray(image)
        g8 = np.clip(np.round(gray * 255.0), 0, 255).astype(np.uint8)
        return {"image_shape": gray.shape, "gray": g8}

    def process_images(self, grays: list) -> dict:
        """Same-shape grayscale uint8 images -> full pipeline outputs."""
        imgs = torch.from_numpy(np.stack([np.asarray(g) for g in grays]))
        return device_pipeline_full(imgs.to(self.device), self.model,
                                    self.mean, self.cfg)

    @staticmethod
    def horizon_line(out: dict) -> np.ndarray:
        return np.cross(np.asarray(out["hp1"].cpu(), np.float64),
                        np.asarray(out["hp2"].cpu(), np.float64))
