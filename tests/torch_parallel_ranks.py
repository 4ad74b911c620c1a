"""Rank programs for tests/test_torch_parallel.py, spawned by
``vanishing_points_2017_tpu_torch.parallel.launch.run_ranks``.

A module of its own (not a test file): the spawned ranks import it by
name, and it imports torch and the port only, so a rank starts without
JAX. Every function runs in each rank on the CPU over gloo (asked for
with ``device="cpu"``: ``initialize`` defaults to the GPU) and returns
numpy arrays."""

from __future__ import annotations

import torch

from vanishing_points_2017_tpu_torch.models import train
from vanishing_points_2017_tpu_torch.parallel import distributed, mesh as pm
from vanishing_points_2017_tpu_torch.parallel.inference import (
    sharded_pipeline_full)
from vanishing_points_2017_tpu_torch.parallel.sharded_lsim import (
    calc_lsim_sharded)
from vanishing_points_2017_tpu_torch.pipeline import build_model
from vanishing_points_2017_tpu_torch.weights import params_from_numpy


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return {k: _np(v) for k, v in tree.items()}


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def mesh_lsim_serving(init_method: str, lp, mask, imgs, params_np,
                      runs) -> dict:
    """4 ranks: mesh shapes and refusals, the sharded lsim (gathered), and
    ``sharded_pipeline_full`` (gathered) for each (name, dp, tp, cfg) of
    ``runs``."""
    distributed.initialize(init_method, backend="gloo", device="cpu")
    out: dict = {"refused": [_raises(lambda: pm.make_mesh(dp=3, tp=2)),
                             _raises(lambda: pm.make_mesh(dp=4, tp=2))]}
    m = pm.make_mesh(dp=2, tp=2)
    out["mesh22"] = (m.shape, m.dp_index, m.tp_index)
    m = pm.make_mesh()
    out["mesh_default"] = (m.shape, m.dp_index, m.tp_index)
    lp, mask = torch.from_numpy(lp), torch.from_numpy(mask)
    out["lsim"] = _np(pm.gather_outputs(calc_lsim_sharded(lp, mask, m, 1.0),
                                        m))
    out["lsim_refused"] = _raises(
        lambda: calc_lsim_sharded(lp[:63], mask[:63], m))
    images = torch.from_numpy(imgs)
    for name, dp, tp, cfg in runs:
        model = build_model(params_from_numpy(params_np), cfg)
        mean = torch.zeros((cfg.sphere_size, cfg.sphere_size))
        m = pm.make_mesh(dp=dp, tp=tp)
        res = sharded_pipeline_full(m, images, model, mean, cfg)
        out[name] = _np(pm.gather_outputs(res, m))
        bad = images[:6] if 6 % dp else images[:dp + 1]
        out[f"{name}_refused"] = _raises(
            lambda: sharded_pipeline_full(m, bad, model, mean, cfg))
    return out


def train_steps(init_method: str, runs: dict, dp: int, tp: int) -> dict:
    """One sharded train step per run of ``runs`` (name -> params, images,
    labels, keep masks of the global batch, float32 products): the loss,
    the updated parameters and the new momentum, gathered."""
    distributed.initialize(init_method, backend="gloo", device="cpu")
    m = pm.make_mesh(dp=dp, tp=tp)
    out = {}
    for name, (params_np, images, labels, keep) in runs.items():
        state = train.init_state(params_from_numpy(params_np), mesh=m)
        state.model.compute_dtype = torch.float32
        x, y = pm.shard_batch([torch.from_numpy(images),
                               torch.from_numpy(labels)], m)
        loss = train.train_step(state, x, y,
                                keep=[torch.from_numpy(k) for k in keep],
                                mesh=m)
        out[name] = {
            "loss": float(loss),
            "params": _np(pm.gather_params(state.model.params(), m)),
            "momentum": _np(pm.gather_params(state.momentum, m))}
    return out


def multislice_dry_run(init_method: str, params_np, images, labels,
                       seed: int) -> dict:
    """``initialize`` from the launcher's environment alone (2 nodes of one
    rank each), ``make_multislice_mesh``, and one train step with dropout
    drawn from the (seed, step) generator."""
    distributed.initialize(init_method, device="cpu")
    refused = _raises(lambda: distributed.make_multislice_mesh(tp=2))
    m = distributed.make_multislice_mesh(tp=1)
    state = train.init_state(params_from_numpy(params_np), mesh=m)
    x, y = pm.shard_batch([torch.from_numpy(images),
                           torch.from_numpy(labels)], m)
    loss = train.train_step(state, x, y,
                            train.step_generator(seed, 0, "cpu"), mesh=m)
    return {"loss": float(loss), "refused": refused, "shape": m.shape}


def hang(init_method: str) -> None:
    """A rank that never returns."""
    import time
    time.sleep(3600)
