"""The port's dp x tp parallelism (``vanishing_points_2017_tpu_torch.parallel``)
against its own single-process functions and the JAX package's
``parallel/``, on the CPU.

The sharded runs are groups of ranks spawned over gloo
(``parallel/launch.run_ranks``: a ``file://`` store under ``tmp_path``, one
thread per rank, each group joined with its own deadline); the rank
programs are in ``torch_parallel_ranks.py``. Sizes are small: 160x160
images, sphere 200, fc widths 256, fc input 120 for training.

The JAX package's own sharded runs (its ``sharded_pipeline_full`` and its
train step under a ``Mesh``) run on 4 of the conftest's 8 virtual CPU
devices as a (2, 2) mesh, on the same inputs."""

import dataclasses
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks as ranks
from vanishing_points_2017_tpu import pipeline as jpipe
from vanishing_points_2017_tpu.em import EMConfig as JEMConfig
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.models import train as jtrain
from vanishing_points_2017_tpu.ops import lines as jlines
from vanishing_points_2017_tpu.parallel import mesh as jmesh
from vanishing_points_2017_tpu.parallel.inference import (
    sharded_pipeline_full as jax_sharded_pipeline_full)
from vanishing_points_2017_tpu.parallel.sharded_lsim import (
    calc_lsim_sharded as jax_lsim_sharded)
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data.datasets import render_scene_image
from vanishing_points_2017_tpu_torch.em import EMConfig
from vanishing_points_2017_tpu_torch.models import cnn, synth, train
from vanishing_points_2017_tpu_torch.ops import lines as tlines
from vanishing_points_2017_tpu_torch.parallel import mesh as pm
from vanishing_points_2017_tpu_torch.parallel.launch import run_ranks
from vanishing_points_2017_tpu_torch.pipeline import (
    PipelineConfig, build_model, device_pipeline_full)
from vanishing_points_2017_tpu_torch.weights import params_from_numpy
from torch_cpu import torch_threads  # noqa: F401

# JAX's keep masks of a key: the reference script's helper
_spec = importlib.util.spec_from_file_location(
    "make_jax_reference_train",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "make_jax_reference_train.py"))
jref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jref)

TIMEOUT = 240  # seconds per group of ranks
CFG = PipelineConfig(sphere_size=200, n_pad=128, em=EMConfig(num_iter=12))
# float32 CNN products for the comparison with JAX, as in
# tests/test_torch_pipeline.py (the JAX package's exact top-k detector)
CFG32 = dataclasses.replace(CFG, cnn_dtype="float32")
JCFG32 = jpipe.PipelineConfig(sphere_size=200, n_pad=128,
                              em=JEMConfig(num_iter=12), det_topk="exact",
                              cnn_dtype="float32")
RUNS = (("serve4x1", 4, 1, CFG), ("serve2x2", 2, 2, CFG),
        ("serve2x2_f32", 2, 2, CFG32))
TRAIN_KEY = 11  # JAX PRNGKey of the train step's dropout masks


def _jax_mesh22():
    """A (dp, tp) = (2, 2) JAX mesh on 4 of the 8 virtual devices."""
    return jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])


def _factorized(params: dict, rank: int, seed: int) -> dict:
    """fc6 and fc7 as random rank-``rank`` u @ v pairs (JAX layout)."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for name in ("fc6", "fc7"):
        w = params[name]["w"]
        out[name] = {
            "u": (rng.normal(size=(w.shape[0], rank)) * 0.02).astype(
                np.float32),
            "v": (rng.normal(size=(rank, w.shape[1])) * 0.05).astype(
                np.float32),
            "b": params[name]["b"]}
    return out


def _lsim_inputs():
    rng = np.random.default_rng(0)
    lp = rng.uniform(-1, 1, size=(64, 4)).astype(np.float32)
    return lp, np.arange(64) < 50


def _images():
    rng = np.random.default_rng(7)
    return np.stack([render_scene_image(
        synth.make_scene(rng, lines_per_vp=10, outliers=3), size=160,
        rng=rng).astype(np.uint8) for _ in range(8)])


def _serving_params():
    return _factorized(cnn.init_params(0, input_size=200, fc_width=256), 64,
                       1)


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    """One 4-rank group: meshes, the sharded lsim and sharded serving."""
    lp, mask = _lsim_inputs()
    res = run_ranks(ranks.mesh_lsim_serving, 4,
                    (lp, mask, _images(), _serving_params(), RUNS),
                    work_dir=str(tmp_path_factory.mktemp("group4")),
                    timeout=TIMEOUT)
    return res


@pytest.fixture(scope="module")
def single_serving():
    model = build_model(params_from_numpy(_serving_params()), CFG)
    out = device_pipeline_full(torch.from_numpy(_images()), model,
                               torch.zeros((200, 200)), CFG)
    return {k: v.numpy() for k, v in out.items()}


def _flat_leaves(params: dict):
    return [(layer, key, v) for layer, d in params.items()
            for key, v in d.items()]


@pytest.mark.parametrize("compact", [False, True])
def test_param_spec_matches_jax(compact):
    """Every leaf's split dimension is where JAX's PartitionSpec puts
    'tp', dense and factorized."""
    jparams = cnn.init_params(0, input_size=120, fc_width=256)
    if compact:
        jparams = _factorized(jparams, 64, 0)
    tparams = params_from_numpy(jparams)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        spec = jmesh.param_spec(path, leaf)
        want[(path[0].key, path[1].key)] = (
            list(spec).index("tp") if "tp" in spec else None)
    got = {(layer, key): pm.param_spec(layer, key, v)
           for layer, key, v in _flat_leaves(tparams)}
    assert got == want
    if compact:
        assert got[("fc6", "u")] == 1 and got[("fc6", "v")] == 1
        assert got[("fc7", "u")] == 0 and got[("fc7", "v")] == 0


def test_shard_params_and_batch_round_trip():
    """A 1 x 1 mesh without a process group; the slices of a 2-way tp
    mesh, put back together, give the whole parameters."""
    m = pm.make_mesh()
    assert m.shape == {"dp": 1, "tp": 1} and m.dp_group is None
    with pytest.raises(ValueError):
        pm.make_mesh(dp=2)
    params = params_from_numpy(_factorized(
        cnn.init_params(0, input_size=120, fc_width=256), 64, 0))
    shards = [pm.shard_params(params, pm.Mesh(1, 2, 0, t)) for t in (0, 1)]
    for layer, key, v in _flat_leaves(params):
        dim = pm.param_spec(layer, key, v)
        parts = [s[layer][key] for s in shards]
        whole = parts[0] if dim is None else torch.cat(parts, dim)
        assert torch.equal(whole, v), (layer, key)
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(pm.shard_batch({"x": x}, pm.Mesh(3, 1, 1, 0))["x"],
                       x[2:4])
    with pytest.raises(ValueError):
        pm.shard_batch(x, pm.Mesh(4, 1, 0, 0))


def test_make_mesh_shapes(group4):
    for rank, r in enumerate(group4):
        assert r["refused"] == [True, True]
        assert r["mesh22"] == ({"dp": 2, "tp": 2}, rank // 2, rank % 2)
        assert r["mesh_default"] == ({"dp": 4, "tp": 1}, rank, 0)


def test_sharded_lsim_matches_dense_and_jax(group4):
    lp, mask = _lsim_inputs()
    dense = tlines.calc_lsim(torch.from_numpy(lp), torch.from_numpy(mask),
                             sigma=1.0).numpy()
    jax_sharded = np.asarray(jax_lsim_sharded(
        jnp.asarray(lp), jnp.asarray(mask), jmesh.make_mesh(dp=8, tp=1),
        sigma=1.0))
    np.testing.assert_allclose(dense, np.asarray(jlines.calc_lsim(
        jnp.asarray(lp), jnp.asarray(mask), sigma=1.0)), atol=2e-6)
    for r in group4:
        assert r["lsim"].shape == (64, 64)
        np.testing.assert_allclose(r["lsim"], dense, atol=2e-6)
        np.testing.assert_allclose(r["lsim"], jax_sharded, atol=2e-6)
        assert r["lsim_refused"]


def test_calc_lsim_row_strips_equal_dense():
    """``calc_lsim`` and the pairwise helpers restricted to row strips,
    stacked, give the dense matrices exactly (batched, degenerate and
    masked segments included)."""
    rng = np.random.default_rng(4)
    lp = torch.from_numpy(rng.uniform(-1, 1, (3, 48, 4)).astype(np.float32))
    lp[:, 5, 2:] = lp[:, 5, :2]
    mask = torch.from_numpy(rng.uniform(size=(3, 48)) < 0.8)
    strips = [(r, r + 12) for r in range(0, 48, 12)]
    for dense, strip in (
            (tlines.calc_lsim(lp, mask, 1.0),
             lambda rows: tlines.calc_lsim(lp, mask, 1.0, rows=rows)),
            (tlines.pairwise_closest_distance(lp),
             lambda rows: tlines.pairwise_closest_distance(lp, rows)),
            (tlines.pairwise_cosangle(lp, 9.0),
             lambda rows: tlines.pairwise_cosangle(lp, 9.0, rows))):
        assert torch.equal(torch.cat([strip(r) for r in strips], -2), dense)


def test_sharded_serving_dp_equals_single_process(group4, single_serving):
    """dp = 4, tp = 1: every output of every image exactly equal."""
    for r in group4:
        got = r["serve4x1"]
        assert set(got) == set(single_serving)
        for k, v in single_serving.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert r["serve4x1_refused"]


def test_sharded_serving_dp_tp_within_jax_tolerances(group4,
                                                     single_serving):
    """dp = 2, tp = 2 (factorized fc6/fc7 split): within the JAX package's
    own sharded-serving tolerances (tests/test_sharding.py)."""
    for r in group4:
        got = r["serve2x2"]
        np.testing.assert_array_equal(got["em_valid"],
                                      single_serving["em_valid"])
        for key, atol in (("hp1", 5e-4), ("hp2", 5e-4), ("vp", 5e-4),
                          ("counts", 1.5)):
            np.testing.assert_allclose(got[key], single_serving[key],
                                       atol=atol, err_msg=key)
        np.testing.assert_allclose(got["cnn_prediction"],
                                   single_serving["cnn_prediction"],
                                   atol=2e-2)
        assert r["serve2x2_refused"]


def test_sharded_serving_dp_tp_matches_jax_sharded(group4):
    """dp = 2, tp = 2, float32 CNN: the port's sharded serving against the
    JAX package's ``sharded_pipeline_full`` on a (2, 2) mesh, same images
    and factorized parameters, within the port's single-device tolerances
    to JAX (tests/test_torch_pipeline.py): CNN grids within 1e-4, the same
    VPs alive, counts within 1, horizons within 1e-3 normalized error,
    sphere images off by <= 1 on at most 3% of pixels."""
    imgs = _images()
    want = jax_sharded_pipeline_full(
        _jax_mesh22(), jnp.asarray(imgs),
        jax.tree.map(jnp.asarray, _serving_params()),
        np.zeros((200, 200), np.float32), JCFG32)
    want = {k: np.asarray(v) for k, v in want.items()}
    for r in group4:
        got = r["serve2x2_f32"]
        assert r["serve2x2_f32_refused"]
        np.testing.assert_array_equal(got["em_valid"], want["em_valid"])
        np.testing.assert_array_equal(got["alive"], want["alive"])
        assert np.abs(got["counts"] - want["counts"]).max() <= 1
        np.testing.assert_allclose(got["cnn_prediction"],
                                   want["cnn_prediction"], atol=1e-4)
        du8 = np.abs(got["sphere_image"].astype(int)
                     - want["sphere_image"].astype(int))
        assert du8.max() <= 1 and np.mean(du8 > 0) <= 3e-2
        for i in range(len(imgs)):
            est = np.cross(got["hp1"][i].astype(np.float64),
                           got["hp2"][i].astype(np.float64))
            ref = np.cross(want["hp1"][i].astype(np.float64),
                           want["hp2"][i].astype(np.float64))
            assert tio.normalized_horizon_error(est, ref, 160, 160) < 1e-3, i


def _train_runs():
    """name -> (params, NCHW images, labels, JAX's keep masks of
    PRNGKey(TRAIN_KEY) for the batch of 4)."""
    rng = np.random.default_rng(3)
    dense = cnn.init_params(5, input_size=120, fc_width=256)
    images = rng.normal(0, 20, size=(4, 1, 120, 120)).astype(np.float32)
    labels = rng.uniform(size=(4, 20, 20)).astype(np.float32)
    keep = jref.keep_masks(jax.random.PRNGKey(TRAIN_KEY), 4, (256, 256))
    return {"dense": (dense, images, labels, keep),
            "compact": (_factorized(dense, 64, 6), images, labels, keep)}


@pytest.fixture(scope="module")
def train_group(tmp_path_factory):
    """One float32 train step of each run on a 4-rank 2 x 2 mesh."""
    return run_ranks(ranks.train_steps, 4, (_train_runs(), 2, 2),
                     work_dir=str(tmp_path_factory.mktemp("train")),
                     timeout=TIMEOUT)


def test_sharded_train_step_equals_single_process(train_group):
    """One float32 step on a 2 x 2 mesh: the loss and every updated
    parameter within rtol 1e-5 of the single-process step, dense and
    factorized."""
    for name, (params_np, images, labels, keep) in _train_runs().items():
        state = train.init_state(params_from_numpy(params_np))
        state.model.compute_dtype = torch.float32
        loss = float(train.train_step(
            state, torch.from_numpy(images), torch.from_numpy(labels),
            keep=[torch.from_numpy(k) for k in keep]))
        want = {layer: {k: v.detach().numpy() for k, v in d.items()}
                for layer, d in state.model.params().items()}
        for r in train_group:
            assert r[name]["loss"] == pytest.approx(loss, rel=1e-5), name
            for layer, key, v in _flat_leaves(want):
                np.testing.assert_allclose(r[name]["params"][layer][key], v,
                                           rtol=1e-5, atol=1e-9,
                                           err_msg=f"{name} {layer}/{key}")


def _jax_mesh_step(params_np, images_nhwc, labels):
    """JAX's train step on its (2, 2) mesh in float32 products: the params
    and the batch placed by ``mesh.shard_params`` / ``shard_batch``, the
    loss and grads of ``cnn.forward(train=True)`` with dropout drawn from
    PRNGKey(TRAIN_KEY), then JAX's Caffe update from zero momentum.
    Returns (loss, new params, new momentum), numpy in the port's layout."""
    mesh = _jax_mesh22()
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, params_np), mesh)
    x, y = jmesh.shard_batch((jnp.asarray(images_nhwc), jnp.asarray(labels)),
                             mesh)
    key = jax.random.PRNGKey(TRAIN_KEY)

    def loss_fn(p):
        logits = jcnn.forward(p, x, train=True, rng=key,
                              compute_dtype=jnp.float32, logits=True)
        return jtrain.sigmoid_xent(logits, y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new, mom = jref.jax_update(params, grads,
                               jax.tree.map(jnp.zeros_like, params), 0)

    def port_layout(tree):
        return {layer: {k: v.numpy() for k, v in d.items()} for layer, d in
                params_from_numpy(jax.tree.map(np.asarray, tree)).items()}
    return float(loss), port_layout(new), port_layout(mom)


@pytest.mark.parametrize("name", ["dense", "compact"])
def test_sharded_train_step_matches_jax_mesh_step(train_group, name):
    """The port's 2 x 2 step against JAX's step on a (2, 2) mesh, float32,
    the same batch and keep masks: the loss and every updated parameter at
    rtol 1e-5; the step's update (the new momentum, -lr (g + wd p)) within
    1e-4 of each leaf's largest, the float32 grads' tolerance in
    tests/test_torch_train_grads.py. Measured on the CPU: losses 0 and
    3.3e-7 relative apart (dense, compact), updates within 1.1e-6 of
    their largest."""
    params_np, images, labels, _ = _train_runs()[name]
    loss, new, mom = _jax_mesh_step(params_np, images.transpose(0, 2, 3, 1),
                                    labels)
    for r in train_group:
        got = r[name]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        for layer, key, v in _flat_leaves(new):
            np.testing.assert_allclose(got["params"][layer][key], v,
                                       rtol=1e-5, atol=1e-9,
                                       err_msg=f"{layer}/{key}")
            m = mom[layer][key]
            err = np.abs(got["momentum"][layer][key] - m).max()
            assert err <= 1e-4 * np.abs(m).max(), (layer, key, err)


def test_multislice_dry_run_two_processes(tmp_path):
    """Two ranks told they are two nodes of one rank: ``initialize`` from
    the environment, ``make_multislice_mesh`` refuses tp = 2 and gives dp =
    2; one step with generator-drawn dropout gives the same loss on both
    ranks and the single-process loss."""
    dense, images, labels, _ = _train_runs()["dense"]
    res = run_ranks(ranks.multislice_dry_run, 2, (dense, images, labels, 9),
                    work_dir=str(tmp_path), timeout=TIMEOUT, local_world=1)
    assert res[0] == res[1]
    assert res[0]["refused"] and res[0]["shape"] == {"dp": 2, "tp": 1}
    state = train.init_state(params_from_numpy(dense))
    loss = float(train.train_step(state, torch.from_numpy(images),
                                  torch.from_numpy(labels),
                                  train.step_generator(9, 0, "cpu")))
    assert res[0]["loss"] == pytest.approx(loss, rel=1e-3)


def test_initialize_refuses_nccl_with_more_ranks_than_gpus(monkeypatch,
                                                          tmp_path):
    """Four ranks on a node with one GPU: nccl (the default, or asked for)
    raises before any process group starts; only gloo may share the card."""
    from vanishing_points_2017_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    store = "file://" + str(tmp_path / "store")
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="gloo"):
            distributed.initialize(store, world_size=4, rank=3,
                                   backend=backend)
    assert not torch.distributed.is_initialized()


def test_initialize_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch,
                                                        tmp_path):
    """With no device named, ``initialize`` wants a GPU: without one it
    raises before any process group starts, instead of carrying on on the
    CPU; the CPU is used only when the caller asks for it."""
    from vanishing_points_2017_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = "file://" + str(tmp_path / "store")
    for kw in ({}, {"backend": "gloo"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            distributed.initialize(store, world_size=1, rank=0, **kw)
    assert not torch.distributed.is_initialized()
    dev = distributed.initialize(store, world_size=1, rank=0, device="cpu")
    try:
        assert dev == torch.device("cpu")
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()


def test_run_ranks_times_out(tmp_path):
    """A hung rank fails its group at the deadline."""
    with pytest.raises(TimeoutError):
        run_ranks(ranks.hang, 2, work_dir=str(tmp_path), timeout=2)
