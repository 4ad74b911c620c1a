"""The port at the HD frames' sizes (1280x720 and 1920x1080: gradient
grids 719x1279 and 1079x1919, where K1 takes its 8-warp kernel on the
card) against the committed JAX reference
``assets/examples/jax_reference_hd.npz`` (``scripts/make_jax_reference_hd.py``;
JAX on the CPU, shipped weights, exact top-k), and the helpers
``chip_smoke.py`` uses to check the kernels' builds.

The frames are re-rendered from the file's seeds; their digests must be
the committed ones. On the CPU the port's ``process_images`` runs the
plain twins; each horizon must lie within 0.02 (normalized by the frame's
height, as the data-set benchmarks measure) of JAX's, the gate
``chip_smoke.py`` applies on the GPU."""

import os
import sys

import numpy as np
import pytest

from vanishing_points_2017_tpu_torch import kernels
from vanishing_points_2017_tpu_torch.data.io import normalized_horizon_error
from vanishing_points_2017_tpu_torch.pipeline import Pipeline, PipelineConfig
from vanishing_points_2017_tpu_torch.weights import load_params_and_mean
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (HD_REFERENCE, HORIZON_TOL,  # noqa: E402
                        K1_SWITCH_WIDTHS, hd_frames, k1_switch_faults)


@pytest.fixture(scope="module")
def frames():
    return hd_frames()


def test_hd_frames_are_the_committed_ones(frames):
    """8 frames, 4 per shape, re-rendered to the committed sha256 (the
    render raises otherwise), each with its seed, shape and JAX outputs."""
    ref = np.load(HD_REFERENCE)
    assert {k: len(v) for k, v in frames.items()} == {(1280, 720): 4,
                                                      (1920, 1080): 4}
    for (w, h), imgs in frames.items():
        assert all(img.shape == (h, w) and img.dtype == np.uint8
                   for img in imgs)
    assert ref["hp1"].shape == ref["hp2"].shape == (8, 3)
    assert len(set(ref["seed"].tolist())) == 8
    assert (ref["segments"] > 50).all()


@pytest.mark.parametrize("i", [0, 1])
def test_hd_720p_horizon_matches_jax(frames, i):
    """One 1280x720 frame of the reference through the port's
    ``process_images`` on the CPU: the same segment count as JAX's
    detector and the horizon within HORIZON_TOL of JAX's."""
    ref = np.load(HD_REFERENCE)
    params, mean = load_params_and_mean(device="cpu")
    pipe = Pipeline(params, mean, PipelineConfig(), device="cpu")
    out = pipe.process_images([frames[(1280, 720)][i]])
    assert int(out["segment_mask"][0].sum()) == int(ref["segments"][i])
    est = np.cross(out["hp1"][0].double().numpy(),
                   out["hp2"][0].double().numpy())
    e = normalized_horizon_error(
        est, np.cross(ref["hp1"][i].astype(np.float64),
                      ref["hp2"][i].astype(np.float64)), 1280, 720)
    assert e <= HORIZON_TOL


def test_ptxas_usage_reads_each_kernel():
    """The build log's report: each kernel's name, registers and spill
    bytes, as chip_smoke.py checks them."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__87010bb7_13_ccl_raster_cu_3b2fb43b18ccl_half_pass_wideILi8ELi5ELi1EEEvPKiS2_Piii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__87010bb7_13_ccl_raster_cu_3b2fb43b18ccl_half_pass_wideILi8ELi5ELi1EEEvPKiS2_Piii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 89 registers, used 1 barriers, 12832 bytes smem
ptxas info    : Compiling entry function '_Z13sphere_renderPKfS0_Pfiiif' for 'sm_90a'
ptxas info    : Function properties for _Z13sphere_renderPKfS0_Pfiiif
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers
"""
    assert kernels.ptxas_usage(log) == [
        {"name": "_ZN46_GLOBAL__N__87010bb7_13_ccl_raster_cu_3b2fb43b18ccl_"
                 "half_pass_wideILi8ELi5ELi1EEEvPKiS2_Piii",
         "spill_stores": 0, "spill_loads": 0, "registers": 89},
        {"name": "_Z13sphere_renderPKfS0_Pfiiif", "spill_stores": 4,
         "spill_loads": 8, "registers": 40}]
    assert kernels.ptxas_usage("") == []


def _kernel_of(w, last_4=1024, last_8=2048):
    """A stand-in for K1's launched kernel at width w: (warps, columns per
    lane) of a width table with these last widths for 4 and 8 warps."""
    warps = 4 if w <= last_4 else 8 if w <= last_8 else 16 if w <= 4096 \
        else 32 if w <= 5120 else 0
    return "groups" if not warps else f"{warps},{-(-w // (32 * warps))}"


@pytest.mark.parametrize("last_4,last_8,faults", [
    (1024, 2048, 0), (768, 2048, 1), (1000, 2048, 1), (1024, 1536, 1)])
def test_k1_switch_faults_find_a_table_that_moved(last_4, last_8, faults):
    """chip_smoke.py's check of K1_SWITCH_WIDTHS against the launched
    kernels at each switch width +-1: silent on the table they list; when
    a warp count's last width moves, a fault for the switch width that no
    longer switches (768: 8 warps from 769 to 1024; 1536: 16 warps from
    1537 to 2048) or for the switch between two of them (1000)."""
    names = {s + d: _kernel_of(s + d, last_4, last_8)
             for s in K1_SWITCH_WIDTHS for d in (-1, 0, 1)}
    assert len(k1_switch_faults(names)) == faults


@pytest.mark.slow
def test_committed_hd_reference_is_current():
    """Regenerates the JAX outputs on the HD frames (~1 min) and checks
    the committed file still holds them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_ref_hd", os.path.join(ROOT, "scripts",
                                    "make_jax_reference_hd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.reference_outputs()
    committed = np.load(mod.DEFAULT_OUT)
    for k, v in fresh.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, committed[k], atol=1e-6,
                                       err_msg=k)
        else:
            assert np.array_equal(v, committed[k]), k
