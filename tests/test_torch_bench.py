"""The port's throughput bench (``python -m vanishing_points_2017_tpu_torch
.bench``) on the CPU: its inputs against the JAX bench's draw, the CNN's
FLOP count against PyTorch's counter and XLA's cost analysis, and one
tiny run of the whole bench."""

import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vanishing_points_2017_tpu import weights as jweights
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu_torch import bench
from vanishing_points_2017_tpu_torch.models import cnn as tcnn
from vanishing_points_2017_tpu_torch.weights import (load_params_and_mean,
                                                     params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED_FLOPS = 6_259_899_584
# XLA does not count the conv taps that fall on padding (conv2-5, ~0.25e9
# per image at 500^2) and adds elementwise work, so its count lies a few
# percent under 2 x the multiply-adds over full windows
XLA_FLOPS_RTOL = 0.04
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_note",
               "degraded", "breakdown"}
BREAKDOWN_KEYS = {
    "includes_detection", "timing_semantics", "platform", "device",
    "power_limit", "torch", "cuda", "image_size", "batch", "det_selection",
    "iters",
    "repeats", "weights_fingerprint", "serial_images_per_sec",
    "compute_images_per_sec", "fused_device_images_per_sec", "spread",
    "host_lsd_ms_per_image", "kernel_build_s", "first_call_s",
    "flops_per_image", "peak_flops", "mfu_estimate", "launches_per_batch",
    "stage_ms", "stage_total_ms", "em_host_syncs", "em_iterations_max",
    "profiled_wall_ms", "device_busy_ms", "device_idle_share",
    "device_idle_note", "top_kernels"}


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "make_ref_bench", os.path.join(ROOT, "scripts",
                                       "make_jax_reference_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counted_flops(params: dict, size: int) -> int:
    net = tcnn.VPNet(params, compute_dtype=torch.float32)
    with FlopCounterMode(display=False) as counter:
        net(torch.zeros(1, 1, size, size))
    return counter.get_total_flops()


def test_inputs_equal_the_jax_draw():
    """Batch 4 at 640^2: the images (uint8) and the padded lines are the
    JAX bench's, bit for bit."""
    got = bench.make_inputs(4, 640, 512)
    ref = _load_script().bench_images(4, 640)
    assert got[0].dtype == np.uint8 and got[0].shape == (4, 640, 640)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_flops_per_image_shipped_weights():
    """The shipped compact weights: exactly PyTorch's count of the forward
    at 500^2, and within XLA_FLOPS_RTOL of XLA's ``cost_analysis`` of the
    JAX package's forward of the same weights on the CPU."""
    params, _ = load_params_and_mean(device="cpu")
    assert tcnn.flops_per_image(params) == SHIPPED_FLOPS
    assert _counted_flops(params, 500) == SHIPPED_FLOPS
    jparams, _ = jweights.load_params_and_mean(warn=False)
    cost = jax.jit(lambda p, x: jcnn.forward(p, x)).lower(
        jparams, jnp.zeros((1, 500, 500, 1), jnp.float32)).compile() \
        .cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = float(cost["flops"])
    assert abs(SHIPPED_FLOPS - xla) <= XLA_FLOPS_RTOL * xla, xla


def test_flops_per_image_dense_narrow():
    """Dense fc layers of width 64 at a 240^2 input: the count from the
    shapes equals PyTorch's counter."""
    params = params_from_numpy(tcnn.init_params(3, input_size=240,
                                                fc_width=64))
    assert tcnn.flops_per_image(params, 240) == _counted_flops(params, 240)


def test_bench_main_on_cpu(monkeypatch):
    """A tiny CPU run (batch 2, one batch per loop, 160^2): the last line
    of stdout is the record, marked degraded with no MFU and no idle
    share, and the pipelined, serial and compute-only loops give the same
    horizons (the fused loop runs on the scenes' own lines, not the
    detector's)."""
    seen = {}
    measure = bench.measure

    def spy(*args, **kwargs):
        record, horizons = measure(*args, **kwargs)
        seen.update(horizons)
        return record, horizons

    monkeypatch.setattr(bench, "measure", spy)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                         "--repeats", "1", "--size", "160"])
    assert rc == 0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(rec) == RECORD_KEYS
    bd = rec["breakdown"]
    assert set(bd) == BREAKDOWN_KEYS
    assert bd["platform"] == "cpu" and rec["degraded"] is True
    assert bd["det_selection"] == "global"
    assert bd["mfu_estimate"] is None and bd["device_idle_share"] is None
    assert bd["device_idle_note"]
    assert bd["flops_per_image"] == SHIPPED_FLOPS
    assert set(bd["stage_ms"]) == set(bench.STAGES)
    assert bd["launches_per_batch"] == {"ccl_raster": 0, "sphere_render": 0}
    assert rec["value"] == bd["spread"]["pipelined"]["median"] > 0
    assert set(seen) == set(bench.LOOPS)
    for loop in bench.LOOPS:
        hp1, hp2 = seen[loop]
        assert hp1.shape == hp2.shape == (2, 3)
        assert np.isfinite(hp1).all() and np.isfinite(hp2).all()
    for loop in ("serial", "compute"):
        hp1, hp2 = seen[loop]
        np.testing.assert_array_equal(hp1, seen["pipelined"][0])
        np.testing.assert_array_equal(hp2, seen["pipelined"][1])


def test_bench_raises_without_a_card():
    """No CUDA device and no ``--device cpu``: the bench raises before
    any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main(["--batch", "2", "--iters", "1", "--repeats", "1"])


@pytest.mark.slow
def test_committed_jax_reference_is_current():
    """Regenerates the JAX horizons chip_smoke.py holds the bench's loops
    against and checks the committed file still holds them."""
    mod = _load_script()
    fresh = mod.reference_outputs()
    committed = np.load(mod.DEFAULT_OUT)
    for k in mod.KEYS:
        np.testing.assert_allclose(fresh[k], committed[k], atol=1e-6,
                                   err_msg=k)
