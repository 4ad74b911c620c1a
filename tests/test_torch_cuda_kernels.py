"""The port's CUDA kernels vs their plain PyTorch twins, and the float32
CNN with TF32 pinned off, on the GPU.

Marked ``gpu``: they need a CUDA card and nvcc (sm_90a), and skip without
one. Run them on the GPU machine (which has no JAX, so the test
conftest, which imports it, is skipped) with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch.models import cnn
from vanishing_points_2017_tpu_torch.ops import lines_device as ld
from vanishing_points_2017_tpu_torch.ops import sphere
from vanishing_points_2017_tpu_torch.weights import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (K1_SWITCH_WIDTHS, k1_launched_kernels,  # noqa: E402
                        k1_switch_faults)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _images(b, size, seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((b, size, size), 200.0, np.float32)
    for i in range(b):
        for _ in range(20):
            x0, y0, x1, y1 = rng.uniform(0, size, 4)
            t = np.linspace(0, 1, 4 * size)
            xs = np.clip((x0 + t * (x1 - x0)).astype(int), 0, size - 1)
            ys = np.clip((y0 + t * (y1 - y0)).astype(int), 0, size - 1)
            img[i, ys, xs] = 40.0
    return torch.from_numpy(img + rng.normal(0, 3, img.shape).astype(
        np.float32))


@pytest.mark.parametrize("size,passes", [(200, 8), (131, 4)])
def test_ccl_kernel_bit_exact(cuda, size, passes):
    _, active, ux, uy = ld.gradient_front(_images(3, size).to(cuda))
    packed = ld.pack_edge_masks(active, ux, uy,
                                math.cos(math.radians(ld.TOL_DEG)))
    before = ld.CCL_KERNEL.launches
    got = ld.connected_components(packed, passes)
    assert ld.CCL_KERNEL.launches == before + 1
    ref = ld.connected_components_ref(packed, passes)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("passes", [2, 16])
def test_ccl_kernel_other_pass_counts(cuda, passes):
    """The detector's ``ccl_passes`` other than 8: bit-exact against the
    twin, and the fixpoint residual of the kernel's labels equal to the
    twin's (two passes leave labels to spread on these lines)."""
    _, active, ux, uy = ld.gradient_front(_images(4, 200, seed=1).to(cuda))
    packed = ld.pack_edge_masks(active, ux, uy,
                                math.cos(math.radians(ld.TOL_DEG)))
    got = ld.connected_components(packed, passes)
    ref = ld.connected_components_ref(packed, passes)
    assert torch.equal(got, ref)
    res = ld.ccl_fixpoint_residual(packed, got)
    assert torch.equal(res, ld.ccl_fixpoint_residual(packed, ref))
    assert (int(res.sum()) > 0) == (passes == 2)


def _plane(kind, b, h, w, seed=0):
    """A packed edge bit-plane: random bits (any plane must give the
    twin's labels, border bits included), mostly-set bits, all set, none."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        p = rng.integers(0, 256, (b, h, w))
    elif kind == "dense":
        p = np.where(rng.uniform(size=(b, h, w)) < 0.9, 0xFF,
                     rng.integers(0, 256, (b, h, w)))
    else:
        p = np.full((b, h, w), 0xFF if kind == "all" else 0)
    return torch.from_numpy(p.astype(np.int32))


@pytest.mark.parametrize("h,w", [(479, 639), (599, 799), (532, 799),
                                 (7, 500), (7, 700), (7, 1023)])
def test_ccl_kernel_bit_exact_on_dataset_grids(cuda, h, w):
    """The real data sets' non-square gradient grids (York Urban's 640x480,
    and 800x600 / 800x533 after the resize to 800) on drawn-line images,
    and the columns-per-lane instantiations no square test reaches (4, 6
    and 8 at W = 500, 700 and 1023) on random planes."""
    if h > 9:
        rng = np.random.default_rng(w)
        img = np.full((2, h + 1, w + 1), 200.0, np.float32)
        for i in range(2):
            for _ in range(30):
                x0, x1 = rng.uniform(0, w, 2)
                y0, y1 = rng.uniform(0, h, 2)
                t = np.linspace(0, 1, 4 * w)
                img[i, np.clip((y0 + t * (y1 - y0)).astype(int), 0, h),
                    np.clip((x0 + t * (x1 - x0)).astype(int), 0, w)] = 40.0
        img += rng.normal(0, 3, img.shape).astype(np.float32)
        _, active, ux, uy = ld.gradient_front(torch.from_numpy(img).to(cuda))
        packed = ld.pack_edge_masks(active, ux, uy,
                                    math.cos(math.radians(ld.TOL_DEG)))
    else:
        packed = _plane("random", 2, h, w).to(cuda)
    assert tuple(packed.shape) == (2, h, w)
    got = ld.connected_components_cuda(packed, 8)
    assert torch.equal(got, ld.connected_components_ref(packed, 8))


@pytest.mark.parametrize("w", [1, 31, 33, 129, 300, 639, 1024, 1025, 1279,
                               1919, 2049, 4031, 4096, 4097, 5120, 5121,
                               8192, 8193])
@pytest.mark.parametrize("h", [1, 9])
@pytest.mark.parametrize("kind", ["random", "dense", "all", "none"])
def test_ccl_kernel_bit_exact_on_planes(cuda, kind, h, w):
    """Lane and warp edges (W = 31, 33: a ragged last lane; 129, 300: a
    ragged last warp), one column, the widest 4-warp grid, the wider
    register kernels (1025: 8 warps, 5 columns per lane; 1279, 1919: a
    720p and a 1080p gradient grid; 2049, 4031, 4096: 16 warps; 4097,
    5120: 32 warps), the group kernel past 5120 columns (5121: one column
    in the sixth group of 1024; 8192, 8193), one row, all-active and
    all-inactive planes."""
    packed = _plane(kind, 2, h, w).to(cuda)
    got = ld.connected_components_cuda(packed, 8)
    assert torch.equal(got, ld.connected_components_ref(packed, 8))


def test_ccl_kernel_switches_at_the_switch_widths(cuda):
    """The kernel K1 launches (as the profiler names it) changes at each
    of chip_smoke's K1_SWITCH_WIDTHS and nowhere between them: one
    kernel per (warps, columns per lane) of the width table, and the
    group kernel past its last width."""
    widths = sorted({s + d for s in K1_SWITCH_WIDTHS for d in (-1, 0, 1)})
    names = k1_launched_kernels(ld, cuda, widths)
    assert k1_switch_faults(names) == []
    assert len(set(names.values())) == len(K1_SWITCH_WIDTHS) + 1


@pytest.mark.parametrize("w", sorted({s + d for s in K1_SWITCH_WIDTHS
                                      for d in (-1, 0, 1)}))
def test_ccl_kernel_bit_exact_at_switch_widths(cuda, w):
    """Every width where K1 changes its warps or columns per lane, +-1,
    so every kernel of its width table, at B = 1, 4 and 32 (one block per
    image: the batch must not change an image's labels)."""
    packed = _plane("random", 32, 9, w, seed=w).to(cuda)
    packed[1] = 0xFF
    ref = ld.connected_components_ref(packed, 8)
    for b in (1, 4, 32):
        got = ld.connected_components_cuda(packed[:b].contiguous(), 8)
        assert torch.equal(got, ref[:b]), f"B={b}"


def test_sphere_kernel_matches_twin(cuda):
    rng = np.random.default_rng(1)
    l = torch.from_numpy(rng.normal(size=(2, 67, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(2, 67)) < 0.8)
    l[0, 3, 1] = 0.0          # vertical image line: atan(+-inf)
    l[1, ~mask[1]] = math.nan  # NaN padding must not leak
    before = sphere.SPHERE_KERNEL.launches
    got = sphere.sphere_render(l.to(cuda), mask.to(cuda), size=150)
    assert sphere.SPHERE_KERNEL.launches == before + 1
    ref = sphere.sphere_render_ref(l.to(cuda), mask.to(cuda), size=150)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-4


def _k2_gate(got, ref):
    """chip_smoke.py's K2 gates: within 1e-4, uint8 off by <= 1 on <= 0.1%
    of pixels."""
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-4
    du8 = (torch.floor(got * 255) - torch.floor(ref * 255)).abs()
    assert float(du8.max()) <= 1 and float((du8 > 0).float().mean()) <= 1e-3


def test_sphere_kernel_edge_cases(cuda):
    """Steep curves whose band is the whole column (l0 >> l1, l2), rows
    centred off the canvas (0/0 -> NaN -> -1e6), N = 0 and a batch whose
    lines are all masked (a black image)."""
    rng = np.random.default_rng(2)
    l = rng.normal(size=(3, 40, 3)).astype(np.float32)
    l[0, :10] = [1.0, 1e-6, 0.0]        # near-vertical curves
    l[0, 10:20, 1] *= 1e-4              # steep
    l[0, 20:25] = 0.0                   # 0/0 at every column
    l[0, 25:30, 1] = 0.0                # l1 = 0: atan(+-inf)
    mask = np.ones((3, 40), bool)
    mask[1] = False                     # every line masked
    mask[2, ::3] = False
    l, mask = torch.from_numpy(l).to(cuda), torch.from_numpy(mask).to(cuda)
    got = sphere.sphere_render_cuda(l, mask, 120)
    _k2_gate(got, sphere.sphere_render_ref(l, mask, 120))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    empty = sphere.sphere_render_cuda(l[:, :0].contiguous(),
                                      mask[:, :0].contiguous(), 120)
    assert torch.equal(empty, torch.zeros_like(empty))


def test_sphere_kernel_at_the_largest_bucket(cuda):
    """S = 500, N = 2048 (the host path's largest line bucket)."""
    rng = np.random.default_rng(3)
    l = torch.from_numpy(rng.normal(size=(2, 2048, 3)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(2, 2048)) < 0.95).to(cuda)
    _k2_gate(sphere.sphere_render_cuda(l, mask, 500),
             sphere.sphere_render_ref(l, mask, 500))


def test_sphere_kernel_is_deterministic(cuda):
    """Two launches give the same bits: each pixel sums its lines in index
    order, with no atomics."""
    rng = np.random.default_rng(4)
    l = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(2, 300)) < 0.9).to(cuda)
    first = sphere.sphere_render_cuda(l, mask, 500)
    assert torch.equal(first, sphere.sphere_render_cuda(l, mask, 500))


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(RuntimeError):  # the kernel's error code: W < 1
        ld.connected_components_cuda(
            torch.zeros((1, 4, 0), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        ld.connected_components_cuda(
            torch.zeros((1, 4, 4), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        sphere.sphere_render_cuda(torch.zeros((1, 8, 3), device=cuda),
                                  torch.zeros((1, 8), dtype=torch.uint8,
                                              device=cuda))


def test_cnn_float32_gpu_matches_cpu(cuda):
    """float32 on cuDNN/cuBLAS with TF32 off agrees with the CPU to 1e-4
    on the sigmoid grid (TF32 would keep ~3 decimal digits)."""
    params = params_from_numpy(cnn.init_params(0, input_size=227,
                                               fc_width=64))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 20, size=(2, 1, 227, 227)).astype(np.float32))
    ref = cnn.VPNet(params)(x)
    gpu_params = {k: {kk: v.to(cuda) for kk, v in d.items()}
                  for k, d in params.items()}
    got = cnn.VPNet(gpu_params)(x.to(cuda)).cpu()
    assert float((got - ref).abs().max()) <= 1e-4
    assert torch.backends.cuda.matmul.allow_tf32 is False
