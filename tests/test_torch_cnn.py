"""VP-grid CNN of the PyTorch port vs the JAX forward pass."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu_torch.models import cnn as tcnn
from vanishing_points_2017_tpu_torch.weights import params_from_numpy
from torch_cpu import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def small_net():
    params = jcnn.init_params(jax.random.PRNGKey(0), input_size=227,
                              fc_width=64)
    npp = {k: {kk: np.asarray(vv) for kk, vv in d.items()}
           for k, d in params.items()}
    x = np.random.default_rng(0).normal(0, 20, size=(2, 227, 227, 1)) \
        .astype(np.float32)
    return params, npp, x


def _torch_forward(npp, x, dtype):
    net = tcnn.VPNet(params_from_numpy(npp), compute_dtype=dtype)
    return net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()


def test_forward_f32_matches_jax(small_net):
    """float32: atol 1e-4 on the sigmoid grid (conv/matmul sum order)."""
    params, npp, x = small_net
    ref = np.asarray(jcnn.forward(params, jnp.asarray(x)))
    got = _torch_forward(npp, x, torch.float32)
    assert got.shape == (2, 20, 20)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_forward_bf16_matches_jax(small_net):
    """bfloat16: both sides round conv/fc products to bf16 at different
    places in their kernels; 2e-2 on the sigmoid grid."""
    params, npp, x = small_net
    ref = np.asarray(jcnn.forward(params, jnp.asarray(x),
                                  compute_dtype=jnp.bfloat16))
    got = _torch_forward(npp, x, torch.bfloat16)
    np.testing.assert_allclose(got, ref, atol=2e-2)


def test_factorized_fc_matches_jax(small_net):
    """A low-rank u/v fc6 (the shipped artifact's layout) applies as x@u@v."""
    params, npp, x = small_net
    rng = np.random.default_rng(1)
    w = npp["fc6"]["w"]
    u = rng.normal(0, 0.01, size=(w.shape[0], 8)).astype(np.float32)
    v = rng.normal(0, 0.5, size=(8, w.shape[1])).astype(np.float32)
    jp = dict(params)
    jp["fc6"] = {"u": jnp.asarray(u), "v": jnp.asarray(v),
                 "b": params["fc6"]["b"]}
    npf = dict(npp)
    npf["fc6"] = {"u": u, "v": v, "b": npp["fc6"]["b"]}
    ref = np.asarray(jcnn.forward(jp, jnp.asarray(x)))
    got = _torch_forward(npf, x, torch.float32)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_lrn_formula_and_torch_builtin_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 3, 3)).astype(np.float32) * 30
    ref = np.asarray(jcnn.lrn_across_channels(
        jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got = tcnn.lrn_across_channels(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    builtin = F.local_response_norm(torch.from_numpy(x), 5, alpha=1e-4,
                                    beta=0.75, k=1.0).numpy()
    np.testing.assert_allclose(builtin, got, rtol=1e-6)


@pytest.mark.parametrize("n,out", [(123, 61), (61, 30), (30, 15)])
def test_caffe_ceil_pool_sizes(n, out):
    x = torch.arange(n * n, dtype=torch.float32).reshape(1, 1, n, n)
    y = tcnn.caffe_max_pool(x)
    assert y.shape[-1] == out
    assert tcnn.pool5_side(500) == 15
    # the last window hangs over the edge: max of the bottom-right block
    assert float(y[0, 0, -1, -1]) == float(x[0, 0, -1, -1])


def test_preprocess_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(2, 16, 16)).astype(np.uint8)
    mean = rng.uniform(0, 30, size=(16, 16)).astype(np.float32)
    ref = np.asarray(jcnn.preprocess(jnp.asarray(img), jnp.asarray(mean)))
    got = tcnn.preprocess(torch.from_numpy(img), torch.from_numpy(mean))
    np.testing.assert_array_equal(got.numpy()[:, 0], ref[..., 0])


def test_grid_independent_of_batch(small_net):
    """VPNet runs in fixed chunks (one image on the CPU; also chunks of 2
    through batching.in_chunks, to cover the padding): an image's grid is
    bit-identical (torch.equal) alone and at batch 3 and 5, at any
    position in the batch."""
    from vanishing_points_2017_tpu_torch.batching import in_chunks

    _, npp, x = small_net
    net = tcnn.VPNet(params_from_numpy(npp), compute_dtype=torch.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    runs = {None: net, 2: lambda t: in_chunks(net.forward_unchunked, [t], 2)}
    for chunk, run in runs.items():
        alone = [run(xt[i:i + 1])[0] for i in range(2)]
        for rows in ([1, 0, 1], [0, 1, 1, 0, 0]):
            got = run(xt[rows])
            assert got.shape == (len(rows), 20, 20)
            for pos, i in enumerate(rows):
                assert torch.equal(got[pos], alone[i]), (chunk, rows, pos)


def test_in_chunks_pads_and_trims():
    """batching.in_chunks pads the last chunk with zeros, calls fn on whole
    chunks only, and returns tensors, tuples and named tuples of the
    original batch size."""
    from typing import NamedTuple

    from vanishing_points_2017_tpu_torch.batching import in_chunks

    class Pair(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor

    seen = []

    def fn(x, m):
        seen.append(x.shape[0])
        return Pair(x * 2, m), x.sum(1)

    x = torch.arange(10.0).reshape(5, 2)
    m = torch.ones(5, dtype=torch.bool)
    pair, s = in_chunks(fn, [x, m], chunk=2)
    assert seen == [2, 2, 2]
    assert isinstance(pair, Pair) and torch.equal(pair.a, x * 2)
    assert torch.equal(pair.b, m) and torch.equal(s, x.sum(1))
