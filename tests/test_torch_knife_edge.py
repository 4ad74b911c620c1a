"""Synthetic scene 12 (seed 7, 640x640): the one device-path scene whose
horizon parts from JAX's by more than 0.02 (0.20 on the CPU, in bf16 and
in float32 alike).

``scripts/trace_synthetic_device_scene.py`` traced it stage by stage: the
two detectors give the same 242 segment slots, with endpoints within
1.0e-5 (float32 sums in another order); the port's EM and horizon search
on JAX's own segments, sphere image and grid give JAX's horizon exactly,
also with the port's sphere image and grid in place of JAX's; with the
port's segments they part by 0.20. So the EM's triplet choice sits on a
knife edge in the segments' float noise: no fault. These tests pin both
halves on JAX's committed stage outputs
(``assets/examples/jax_reference_scene12.npz``, from that script's
``--save``)."""

import os

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch.data.datasets import synthetic_records
from vanishing_points_2017_tpu_torch.data.io import normalized_horizon_error
from vanishing_points_2017_tpu_torch.em.consensus import em_and_horizon
from vanishing_points_2017_tpu_torch.ops.lines import segments_to_homogeneous
from vanishing_points_2017_tpu_torch.ops.lines_device import \
    detect_segments_device
from vanishing_points_2017_tpu_torch.pipeline import Pipeline, PipelineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "assets", "examples", "jax_reference_scene12.npz")


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


def _horizon(ref, segments, mask):
    cfg = PipelineConfig()
    lp = torch.from_numpy(segments[None].copy())
    lm = torch.from_numpy(mask[None].copy())
    with torch.inference_mode():
        _, hz = em_and_horizon(
            torch.where(lm[..., None], segments_to_homogeneous(lp), 0.0), lp,
            torch.from_numpy(ref["cnn_prediction"][None]).float(),
            torch.from_numpy(ref["sphere_image"][None]).float(), lm, cfg.em,
            maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
            pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    return hz[0][0].numpy(), hz[1][0].numpy()


def _err(h, ref):
    line = np.cross(*(np.asarray(x, np.float64) for x in h))
    want = np.cross(*(np.asarray(ref[k], np.float64) for k in ("hp1",
                                                              "hp2")))
    return normalized_horizon_error(line, want, 640, 640)


def test_port_em_on_jax_stage_outputs_gives_jax_horizon(ref):
    assert int(ref["scene"]) == 12
    hp1, hp2 = _horizon(ref, ref["segments"], ref["segment_mask"])
    assert _err((hp1, hp2), ref) < 1e-6


def test_port_segments_are_jax_segments_within_float_noise(ref):
    """The same slots, endpoints within 2e-5 (1.0e-5 measured), and the
    knife edge: the EM on them (JAX's sphere image and grid) parts from
    JAX's horizon by 0.2."""
    records, _ = synthetic_records(count=13)
    gray = Pipeline.ingest_image(records[12].image)["gray"]
    cfg = PipelineConfig()
    lp, lm = detect_segments_device(torch.from_numpy(gray[None]),
                                    **cfg.det_kwargs())
    lp, lm = lp[0].numpy(), lm[0].numpy()
    np.testing.assert_array_equal(lm, ref["segment_mask"])
    assert int(lm.sum()) == 242
    np.testing.assert_allclose(lp[lm], ref["segments"][lm], atol=2e-5)
    assert _err(_horizon(ref, lp, lm), ref) > 0.1
