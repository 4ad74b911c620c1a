"""The port's CUDA kernels vs their plain PyTorch twins, and the float32
CNN with TF32 pinned off, on the GPU.

Marked ``gpu``: they need a CUDA card and nvcc (sm_90a), and skip without
one. Run them on the GPU machine (which has no JAX, so the test
conftest, which imports it, is skipped) with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch.models import cnn
from vanishing_points_2017_tpu_torch.ops import lines_device as ld
from vanishing_points_2017_tpu_torch.ops import sphere
from vanishing_points_2017_tpu_torch.weights import params_from_numpy

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


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        ld.connected_components_cuda(
            torch.zeros((1, 4, 2000), dtype=torch.int32, device=cuda))
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
