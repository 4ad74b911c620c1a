"""The serving job: batches of scenes through the port's entry, one batch
in flight.

Set-up loads or builds the port's kernels, reads the configuration's
weights and hands them to the program (``vpbench/weights.py``), and
draws the cell's pool of batches from the seed (``vpbench/scenes.py``).
The window cycles through the pool in an order drawn from the seed
(``run.window_order``); step ``i`` sends pool batch ``order[i]``: a
host-to-device copy from pinned memory, the entry call
(``pipeline.device_pipeline_full`` on images, ``device_pipeline_batch``
on padded lines), and the horizon's two points read back, which stops
its clock. A step completes the traffic's ``batch`` images. The warm-up
sends the order's last :data:`WARM_BATCHES` batches.

Traced extras: each stage timed in passes of its own over the stretch's
batches (``vpbench/stages.py``) with the EM's host syncs, and the judged
batches' inputs and outputs for a kernel's own timing. The judge: the
plain reference (``vpbench/reference/``) on the judged batches, stage by
stage (``vpbench/judge.py``), on the weights the program was given.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from vpbench import judge as judging
from vpbench import scenes, stages, weights
from vpbench.run import window_order

WARM_BATCHES = 3   # pool batches sent in set-up
# ``pipeline`` keys mapped below; ``chunk`` states the port's fixed chunk
MAPPED = {"sphere_size", "n_pad", "detector", "em", "horizon", "chunk"}


def pipeline_config(config: dict):
    """The configuration's ``pipeline`` section as the port's
    ``PipelineConfig``: the keys of :data:`MAPPED` as set out below, any
    other key as the field of that name (``horizon_consensus``,
    ``consensus_mode``, ...). Raises on a key that names no field, or a
    field the mapped keys already set."""
    from vanishing_points_2017_tpu_torch.em import EMConfig
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    p = config["pipeline"]
    d, hz = p["detector"], p["horizon"]
    kw = dict(
        sphere_size=p["sphere_size"], n_pad=p["n_pad"], em=EMConfig(**p["em"]),
        maxbest=hz["maxbest"], theta_vmin=hz["theta_vmin"],
        horizon_pos_gate_tol=hz["pos_gate_ideal_tol"],
        cnn_dtype=config["precision"]["cnn"], det_min_count=d["min_count"],
        det_min_len_px=d["min_len_px"], det_min_density=d["min_density"],
        det_selection=d["selection"], det_max_records=d["max_records"],
        det_topk=d["topk"])
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    rest = {k: v for k, v in p.items() if k not in MAPPED}
    bad = sorted(k for k in rest if k not in fields or k in kw)
    if bad:
        raise ValueError(f"pipeline keys that name no free PipelineConfig "
                         f"field: {bad}")
    cfg = PipelineConfig(**kw, **rest)
    if cfg.det_kwargs()["max_segments"] != d["max_segments"]:
        raise ValueError("the detector's slots differ from n_pad")
    return cfg


def make_step(model, mean, cfg, dev):
    """The timed path's call: one pool batch (host tensors: ``images``,
    or ``l``, ``lp``, ``lmask``) copied to ``dev`` without blocking and
    sent through the entry -> its outputs on the device."""
    from vanishing_points_2017_tpu_torch.pipeline import (
        device_pipeline_batch, device_pipeline_full)

    def step(host: dict) -> dict:
        x = {n: t.to(dev, non_blocking=True) for n, t in host.items()}
        if "images" in x:
            return device_pipeline_full(x["images"], model, mean, cfg)
        return device_pipeline_batch(x["l"], x["lp"], x["lmask"], model,
                                     mean, cfg)

    return step


def _read_back(out: dict) -> None:
    out["hp1"].cpu(), out["hp2"].cpu()


class Traced:
    """The serving job's extras for the metric readers."""

    def __init__(self, stage_ms: dict, em_syncs: list, judged: list, dev):
        self.stage_ms, self.em_syncs = stage_ms, em_syncs
        self._judged, self._dev = judged, dev

    def stage_median_ms(self, stage: str):
        v = self.stage_ms.get(stage)
        return statistics.median(v) * 1e3 if v else None

    def device_images(self, k: int):
        """The images of the ``k``-th judged batch, on the device."""
        images = self._judged[k][0].get("images")
        return None if images is None else images.to(self._dev)

    def device_lines(self, k: int):
        """The (l, lmask) the ``k``-th judged batch was rendered from in
        the window."""
        batch, o = self._judged[k]
        if "images" in batch:
            from vanishing_points_2017_tpu_torch.ops import lines as lineops
            lm = o["segment_mask"]
            l = torch.where(lm[..., None],
                            lineops.segments_to_homogeneous(o["segments"]),
                            0.0)
            return l, lm
        return batch["l"].to(self._dev), batch["lmask"].to(self._dev)


class Serve:
    """The program, its pool and the window's order for one seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, dev, root: str,
                 mark):
        from vanishing_points_2017_tpu_torch import kernels
        from vanishing_points_2017_tpu_torch.pipeline import Pipeline

        mark("import")
        if dev.type == "cuda":
            for k in kernels.all_kernels():
                k.build()
            torch.cuda.set_device(dev)
        mark("kernels")
        self.config, self.traffic, self.dev = config, traffic, dev
        self.cfg = pipeline_config(config)
        self.params, self.mean = weights.load(config, root, dev)
        self.pipe = Pipeline(self.params, self.mean, self.cfg, device=dev)
        self._step = make_step(self.pipe.model, self.mean, self.cfg, dev)
        mark("weights")
        self.width = config["image"]["width"]
        self.height = config["image"]["height"]
        self.pool = scenes.draw_pool(traffic, self.width, self.height, seed,
                                     dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mark("pool")
        self.items = traffic["batch"]
        self.order, self.judged = window_order(traffic, seed)

    def _batch(self, i: int) -> dict:
        return self.pool.batch(self.order[i % len(self.order)])

    def warm_up(self) -> None:
        for k in self.order[-WARM_BATCHES:]:
            _read_back(self._step(self.pool.batch(k)))

    def step(self, i: int) -> dict:
        out = self._step(self._batch(i))
        _read_back(out)
        return out

    def keep(self, i: int, out: dict) -> tuple:
        """(the batch's host tensors, its outputs on the device)."""
        return self._batch(i), out

    def traced(self, kept: list, n: int) -> Traced:
        stage_ms: dict = {}
        syncs = []
        for i in range(n):
            t, reads = stages.stage_pass(self._batch(i), self.pipe.model,
                                         self.mean, self.cfg)
            for s, v in t.items():
                stage_ms.setdefault(s, []).append(v)
            syncs.append(reads)
        return Traced(stage_ms, syncs, kept, self.dev)

    def free(self) -> None:
        del self._step, self.pipe

    def judge(self, kept: list) -> dict:
        from vpbench.reference.pipeline import Reference

        ref = Reference(self.config, self.params, self.mean)
        batches = [{n: t.to(self.dev) for n, t in b.items()} for b, _ in kept]
        numbers, _ = judging.judge(ref, batches, [o for _, o in kept],
                                   self.traffic["judge"]["check"],
                                   self.width, self.height)
        return numbers


def build(config: dict, traffic: dict, seed: int, dev, root: str,
          mark) -> Serve:
    return Serve(config, traffic, seed, dev, root, mark)
