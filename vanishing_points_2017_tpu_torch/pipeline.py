"""End-to-end pipeline: image -> lines -> sphere -> CNN -> EM -> horizon
(``pipeline.py`` of the JAX package), on one device.

Two paths. The host path (:meth:`Pipeline.ingest` +
:meth:`Pipeline.process_batch`, or :meth:`Pipeline.process` for one image)
runs the C++ LSD on the host, pads each image's lines to the smallest
line bucket that holds them, and sends the padded lines through
:func:`device_pipeline_batch`: sphere render -> CNN -> EM -> horizon.
:func:`device_pipeline_full` is the zero-host-round-trip path: a batch of
uint8 grayscale images goes through the on-device detector and the same
chain without leaving the device (the EM's loop conditions are the only
device-to-host reads). Each entry call is one ``vp.batch`` span
(``utils/profiling.py``): the root of its layers' spans and counters
inside a trace session.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .data import io as dio
from .device import require_device
from .em import EMConfig
from .em.consensus import consensus_em_horizon, em_and_horizon
from .models import cnn as cnn_mod
from .ops import lines as lineops
from .ops import sphere as sphere_mod
from .ops.lines_device import detect_segments_device
from .utils import profiling
from .weights import params_from_numpy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BUCKETS = (512, 1024, 2048)
_log = logging.getLogger(__name__)


def select_bucket(n: int, buckets: tuple = BUCKETS) -> int:
    """Smallest line-count bucket that holds n (the largest if none does)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The JAX package's defaults, but for ``det_topk``. The renderer is
    the kernel (CUDA) or its twin (CPU). ``n_pad`` is the device
    detector's segment budget; the host path picks its line bucket per
    image from ``buckets``.

    ``det_selection``: ``"global"`` (the image-wide top
    ``det_max_records`` runs by mass) or ``"row"`` (a per-row budget,
    whose record set does not depend on image-wide statistics).
    ``det_topk``: ``"exact"`` (the two-stage exact top-k) or ``"approx"``.
    The JAX package defaults to ``"approx"``, its TPU PartialReduce,
    which off the TPU is the one-stage exact sort; here that would sort
    every run end of every image on the main path, so the default stays
    ``"exact"``. Both keep the same records on every available input."""

    sphere_size: int = 500
    n_pad: int = 512
    buckets: tuple = BUCKETS
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
    det_selection: str = "global"
    det_max_records: int = 32768
    det_topk: str = "exact"
    # Bootstrap-consensus horizon (em/consensus.py): 0/1 = off, the
    # reference-parity single EM; K > 1 = K perturbed segment populations
    # through the EM and the horizon search, the medoid member reported.
    horizon_consensus: int = 0
    consensus_seed: int = 0
    consensus_mode: str = "dropout"   # or "bootstrap"
    consensus_guard: float = 0.0      # 0 = always report the medoid

    def __post_init__(self):
        if self.cnn_dtype not in _DTYPES:
            raise ValueError(f"cnn_dtype {self.cnn_dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")
        if self.consensus_mode not in ("dropout", "bootstrap"):
            raise ValueError(f"consensus_mode {self.consensus_mode!r}: "
                             "expected 'dropout' or 'bootstrap'")
        if self.det_selection not in ("global", "row"):
            raise ValueError(f"det_selection {self.det_selection!r}: "
                             "expected 'global' or 'row'")
        if self.det_topk not in ("exact", "approx"):
            raise ValueError(f"det_topk {self.det_topk!r}: "
                             "expected 'exact' or 'approx'")

    def cache_key(self) -> str:
        """Result-cache identity of the configuration: the JAX package's
        fields and spelling, ending in a ``torch`` tag so a cache written
        by one package never serves the other."""
        e = self.em
        hz = ("" if self.horizon_pos_gate_tol == float("inf")
              else f"_hz{self.horizon_pos_gate_tol:g}")
        ck = ("" if self.horizon_consensus <= 1 else
              f"_ck{self.horizon_consensus}"
              + ("" if self.consensus_mode == "dropout"
                 else f"{self.consensus_mode}")
              + (f"g{self.consensus_guard:g}" if self.consensus_guard
                 else "")
              + (f"s{self.consensus_seed}" if self.consensus_seed else ""))
        return (f"{e.distance_measure}_{'' if e.use_weights else 'no'}weights"
                f"_{'' if e.do_split else 'no'}split"
                f"_{'' if e.do_merge else 'no'}merge_{self.sphere_size}{hz}"
                f"{ck}_torch")

    def det_key(self) -> str:
        """Device-detector identity, appended to :meth:`cache_key` for
        results of the on-device detector: the JAX package's spelling of
        the selection, gates, record budget and (when not ``"exact"``)
        top-k, ending in a ``torch`` tag. JAX's CCL part has no
        counterpart: the port has one CCL, whose kernel and twin are
        bit-identical."""
        topk = "" if self.det_topk == "exact" else f"-{self.det_topk}"
        return (f"det{self.det_selection}{self.det_min_count}"
                f"-{self.det_min_len_px:g}-{self.det_min_density:g}"
                f"-{self.det_max_records}{topk}-torch")

    def det_kwargs(self) -> dict:
        """The device detector's arguments under this configuration: every
        caller of :func:`detect_segments_device` on a configuration's
        behalf passes these, the selection and top-k included (the
        function's own default selection is the row one)."""
        return dict(max_segments=self.n_pad, min_count=self.det_min_count,
                    min_len_px=self.det_min_len_px,
                    min_density=self.det_min_density,
                    selection=self.det_selection,
                    max_records=self.det_max_records,
                    topk_impl=self.det_topk)


def pad_lines(segments: np.ndarray, n_pad: int):
    """Normalized segments (n, 4) -> padded (l, lp, lmask) numpy arrays.

    Keeps the n_pad longest when n > n_pad, and says so (a silent cap would
    make dense scenes quietly lose lines); callers that want no truncation
    pick a bucket first with :func:`select_bucket`."""
    n = segments.shape[0]
    if n > n_pad:
        _log.warning("pad_lines: truncating %d segments to the %d longest "
                     "(pick a larger bucket via PipelineConfig.buckets to "
                     "keep all)", n, n_pad)
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
    with profiling.batch():
        img_u8 = sphere_mod.sphere_image_uint8(l, lmask, size=cfg.sphere_size)
        pred = model(cnn_mod.preprocess(img_u8, mean))
        sphere_f32 = img_u8.to(torch.float32)
        horizon_args = dict(maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
                            pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
        extra: dict = {}
        if cfg.horizon_consensus > 1:
            em, hz, extra = consensus_em_horizon(
                l, lp, pred, sphere_f32, lmask, cfg.em,
                k=cfg.horizon_consensus, seed=cfg.consensus_seed,
                mode=cfg.consensus_mode, guard=cfg.consensus_guard,
                **horizon_args)
        else:
            em, hz = em_and_horizon(l, lp, pred, sphere_f32, lmask, cfg.em,
                                    **horizon_args)
        hp1, hp2, z_vp, h_vp1, h_vp2, combo = hz
        return extra | {
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
    with profiling.batch():
        lp, lmask = detect_segments_device(images, **cfg.det_kwargs())
        l = torch.where(lmask[..., None], lineops.segments_to_homogeneous(lp),
                        0.0)
        out = device_pipeline_batch(l, lp, lmask, model, mean, cfg)
        out.update(segments=lp, segment_mask=lmask)
        return out


class Pipeline:
    """Host orchestration around the device program. ``params``: this
    port's layout (``weights.load_params_and_mean``); None = random init
    from ``rng_seed``. Runs on the GPU unless ``device`` says otherwise,
    and raises when there is none."""

    def __init__(self, params: dict | None = None,
                 mean: np.ndarray | torch.Tensor | None = None,
                 cfg: PipelineConfig = PipelineConfig(), rng_seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = require_device(device)
        if params is None:
            params = params_from_numpy(
                cnn_mod.init_params(rng_seed, input_size=cfg.sphere_size))
        params = {k: {kk: vv.to(self.device) for kk, vv in d.items()}
                  for k, d in params.items()}
        self.model = build_model(params, cfg)
        if mean is None:
            mean = np.zeros((cfg.sphere_size, cfg.sphere_size), np.float32)
        self.mean = torch.as_tensor(mean, dtype=torch.float32).to(self.device)

    # ---- host stages

    def ingest(self, image: np.ndarray | str,
               target_size: int | None = None) -> dict:
        """Load, resize, grayscale and host LSD -> the image's line bundle,
        padded to the smallest of ``cfg.buckets`` that holds its lines."""
        if isinstance(image, str):
            image = dio.load_image(image)
        if target_size is not None:
            image = dio.resize_max(image, target_size)
        gray = dio.rgb2gray(image)
        det = dio.detect_lsd_lines(gray)
        n_pad = select_bucket(det["segments"].shape[0], self.cfg.buckets)
        l, lp, lmask = pad_lines(det["segments"], n_pad)
        return {"image_shape": gray.shape, "segments": det["segments"],
                "nfa": det["nfa"], "l": l, "lp": lp, "lmask": lmask}

    @staticmethod
    def ingest_image(image: np.ndarray | str,
                     target_size: int | None = None) -> dict:
        """Load, resize and grayscale only: the device-detector path's host
        stage (detection runs on the device)."""
        if isinstance(image, str):
            image = dio.load_image(image)
        if target_size is not None:
            image = dio.resize_max(image, target_size)
        gray = dio.rgb2gray(image)
        g8 = np.clip(np.round(gray * 255.0), 0, 255).astype(np.uint8)
        return {"image_shape": gray.shape, "gray": g8}

    # ---- device stages

    def process_images(self, grays: list) -> dict:
        """Same-shape grayscale uint8 images -> full pipeline outputs."""
        imgs = torch.from_numpy(np.stack([np.asarray(g) for g in grays]))
        return device_pipeline_full(imgs.to(self.device), self.model,
                                    self.mean, self.cfg)

    def _run(self, l, lp, lmask) -> dict:
        t = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
             for a in (l, lp, lmask))
        return device_pipeline_batch(*t, self.model, self.mean, self.cfg)

    def run_lines(self, l, lp, lmask) -> dict:
        """One image's padded lines (N, ...) -> outputs without a batch
        dim, as tensors on ``self.device``."""
        out = self._run(np.asarray(l)[None], np.asarray(lp)[None],
                        np.asarray(lmask)[None])
        return {k: v[0] for k, v in out.items()}

    def process(self, image: np.ndarray | str,
                target_size: int | None = None) -> dict:
        """One image through the host path -> numpy outputs, plus its
        ``image_shape`` and host ``segments``."""
        host = self.ingest(image, target_size)
        out = self.run_lines(host["l"], host["lp"], host["lmask"])
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out.update(image_shape=host["image_shape"],
                   segments=host["segments"])
        return out

    def process_batch(self, bundles: list[dict]) -> dict:
        """Host-path bundles (:meth:`ingest`) -> batched outputs; a batch of
        mixed buckets is re-padded to its largest bucket."""
        n_pad = max(int(b["l"].shape[0]) for b in bundles)

        def stack(key):
            rows = []
            for b in bundles:
                a = np.asarray(b[key])
                pad = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                rows.append(np.pad(a, pad))
            return np.stack(rows)

        return self._run(stack("l"), stack("lp"), stack("lmask"))

    @staticmethod
    def horizon_line(out: dict) -> np.ndarray:
        """hp1 x hp2 crossed in float32, as the reference crosses them,
        from tensor or numpy outputs."""
        hp1, hp2 = (torch.as_tensor(out[k]).cpu().float().numpy()
                    for k in ("hp1", "hp2"))
        return np.cross(hp1, hp2)
