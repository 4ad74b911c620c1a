"""The port's tracing (``utils/profiling.py``) on the CPU: spans and
counters off by default, the spans a trace session records from a small
pipeline run, the EM's own count of its host reads and loop bodies, and
the attribution of device time and idle on hand-built event lists."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch.data.datasets import render_scene_image
from vanishing_points_2017_tpu_torch.em import em as tem
from vanishing_points_2017_tpu_torch.models import synth
from vanishing_points_2017_tpu_torch.ops import lines as lineops
from vanishing_points_2017_tpu_torch.utils import profiling
from torch_cpu import torch_threads, truth_value_reads  # noqa: F401

CFG = tpipe.PipelineConfig(sphere_size=240, n_pad=256, cnn_dtype="float32")
LAYER_SPANS = {"vp.detector", "vp.render", "vp.cnn", "vp.em", "vp.horizon"}


def _images(n=2, size=128):
    return np.stack([render_scene_image(
        synth.make_scene(np.random.default_rng(i), lines_per_vp=20,
                         outliers=4), size=size, rng=np.random.default_rng(i))
        for i in range(n)])


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) or (a[k].is_floating_point() and torch.equal(
            torch.nan_to_num(a[k], nan=7.0), torch.nan_to_num(b[k], nan=7.0))
            and torch.equal(a[k].isnan(), b[k].isnan()))
        for k in a)


@pytest.fixture(scope="module")
def traced():
    """Two calls of ``device_pipeline_full`` on two small scenes, untraced
    and then inside one session."""
    pipe = tpipe.Pipeline(None, None, CFG, device="cpu")
    imgs = torch.from_numpy(_images())
    pipe.process_images(list(imgs.numpy()))  # first-call rounding
    plain = pipe.process_images(list(imgs.numpy()))
    t_before = time.time_ns()
    with profiling.trace() as rec:
        outs = [tpipe.device_pipeline_full(imgs, pipe.model, pipe.mean, CFG)
                for _ in range(2)]
    t_after = time.time_ns()
    return dict(pipe=pipe, imgs=imgs, plain=plain, outs=outs, rec=rec,
                clock=(t_before, t_after))


def test_off_spans_are_one_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling._session is None
    assert profiling.span("vp.em") is profiling.span("vp.cnn") \
        is profiling.batch() is profiling._NOOP
    profiling.count("em.host_reads")
    with profiling.span("vp.em"), profiling.batch():
        profiling.count("em.host_reads", 3)
    pipe = tpipe.Pipeline(None, None, CFG, device="cpu")
    out = pipe.process_images(list(_images(1)))
    assert out["hp1"].shape == (1, 3)
    assert profiling._session is None


def test_one_batch_span_per_entry_call(traced):
    rec = traced["rec"]
    names = [n for n, _, _ in rec.host]
    assert names.count("vp.batch") == 2 and len(rec.batches) == 2
    for b in rec.batches:
        # device_pipeline_batch inside device_pipeline_full opens no
        # second root; the CPU runs each image's EM and horizon alone
        assert b["spans"]["vp.batch"] == 1
        assert b["spans"]["vp.detector"] == b["spans"]["vp.detector.ccl"] \
            == b["spans"]["vp.render"] == b["spans"]["vp.cnn"] == 1
        assert b["spans"]["vp.em"] == b["spans"]["vp.horizon"] == 2
        assert b["spans"]["vp.em.iteration"] >= 2
        assert b["counters"]["em.host_reads"] > 0
        assert set(b["idle_ms"]) == LAYER_SPANS | {"outside"}


def test_spans_nest_in_their_layers_and_batch(traced):
    rec = traced["rec"]
    spans = [h for h in rec.host if h[0] != profiling.SESSION]

    def inside(child, parent):
        return [any(p[1] <= c[1] and c[2] <= p[2]
                    for p in spans if p[0] == parent)
                for c in spans if c[0] == child]

    assert all(inside("vp.detector.ccl", "vp.detector"))
    for sub in ("vp.em.setup", "vp.em.iteration", "vp.em.finalize"):
        assert all(inside(sub, "vp.em")) and inside(sub, "vp.em"), sub
    for layer in LAYER_SPANS | {"vp.detector.ccl", "vp.em.iteration"}:
        assert all(inside(layer, "vp.batch")), layer
    batches = sorted(h for h in spans if h[0] == "vp.batch")
    assert batches[0][2] <= batches[1][1]  # never nested


def test_spans_lie_in_the_session_on_kinetos_clock(traced):
    rec = traced["rec"]
    t0, t1 = rec.bounds
    lo, hi = traced["clock"]
    # kineto stamps host spans on the epoch clock its device activity uses
    assert lo - 50_000_000 <= t0 < t1 <= hi + 50_000_000
    assert all(t0 <= s <= e <= t1 for _, s, e in rec.host)
    assert rec.window_ms == pytest.approx((t1 - t0) / 1e6)


def test_no_aten_op_is_recorded(traced):
    names = {n for n, _, _ in traced["rec"].host}
    assert names == LAYER_SPANS | {"vp.batch", "vp.detector.ccl",
                                   "vp.em.setup", "vp.em.iteration",
                                   "vp.em.finalize", profiling.SESSION}


def test_outputs_are_bit_identical_with_tracing_on(traced):
    for out in traced["outs"]:
        assert _same(out, traced["plain"])


def test_idle_adds_up_to_the_session(traced):
    rec = traced["rec"]
    # no device here: the whole session is idle, split by layer
    assert rec.busy_ms == 0 and rec.idle_ms == pytest.approx(rec.window_ms)
    total = sum(sum(b["idle_ms"].values()) for b in rec.batches)
    assert total == pytest.approx(rec.idle_ms, rel=1e-9)
    for b in rec.batches:
        for layer in LAYER_SPANS:
            assert b["idle_ms"][layer] <= b["span_ms"][layer] + 1e-9


def _em_inputs(traced):
    o = traced["plain"]
    lp, lm = o["segments"], o["segment_mask"]
    l = torch.where(lm[..., None], lineops.segments_to_homogeneous(lp), 0.0)
    return [l, lp, o["cnn_prediction"], o["sphere_image"].float(), lm]


@pytest.mark.parametrize("loop", ["uniform", "phase"])
def test_em_host_reads_match_the_monkeypatched_count(traced, loop):
    cfg = dataclasses.replace(CFG.em, loop=loop, split_merge_freq=3)
    args = _em_inputs(traced)
    with truth_value_reads() as n, profiling.trace() as rec:
        tem.expectation_maximisation(*args, cfg)
    assert n["n"] > 0
    # outside any vp.batch, the count is the session's; on the CPU every
    # stretch runs op by op
    assert rec.batches == []
    assert rec.counters == {"em.host_reads": n["n"],
                            "em.eager_segments":
                                rec.counters["em.eager_segments"]}
    assert rec.counters["em.eager_segments"] > 0


def test_em_trips_count_the_iteration_calls(traced, monkeypatch):
    calls = []
    orig = tem._iteration

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tem, "_iteration", counting)
    pipe = traced["pipe"]
    with profiling.trace() as rec:
        out = tpipe.device_pipeline_full(traced["imgs"], pipe.model,
                                         pipe.mean, CFG)
    (b,) = rec.batches
    assert b["spans"]["vp.em.iteration"] == len(calls) > 0
    assert _same(out, traced["plain"])


def test_consensus_members_run_in_em_spans(traced):
    """The consensus path's EM runs through the same spans: K members of
    each image, one EM call each on the CPU, inside one batch."""
    pipe = traced["pipe"]
    o = traced["plain"]
    lp, lm = o["segments"], o["segment_mask"]
    l = torch.where(lm[..., None], lineops.segments_to_homogeneous(lp), 0.0)
    cfg = dataclasses.replace(CFG, horizon_consensus=2)
    with profiling.trace() as rec:
        tpipe.device_pipeline_batch(l, lp, lm, pipe.model, pipe.mean, cfg)
    (b,) = rec.batches
    assert b["spans"]["vp.em"] == b["spans"]["vp.horizon"] == 2 * 2
    assert "vp.detector" not in b["spans"]


MS = 1_000_000  # one unit of the hand-built timelines: 1 ms in ns


def _events(host, dev, launches=()):
    ev = [("span", n, s * MS, e * MS, 0) for n, s, e in host]
    ev += [("device", "k", s * MS, e * MS, c) for s, e, c in dev]
    ev += [("launch", "cudaLaunchKernel", t * MS, t * MS + 1, c)
           for t, c in launches]
    return ev


HOST = [("vp.session", 0, 1000), ("vp.batch", 100, 900),
        ("vp.detector", 100, 400), ("vp.detector.ccl", 200, 300),
        ("vp.em", 400, 800), ("vp.em.iteration", 450, 500)]


@pytest.mark.parametrize("name,layer", [
    ("vp.detector", "vp.detector"), ("vp.detector.ccl", "vp.detector"),
    ("vp.em.iteration", "vp.em"), ("vp.em.setup", "vp.em"),
    ("vp.em.finalize", "vp.em"), ("vp.emx", "outside"),
    ("vp.batch", "outside"), ("vp.train", "outside"),
    ("vp.train.update", "vp.train.update"),
    ("vp.train.update.foreach", "vp.train.update"),
    ("vp.train.input", "vp.train.input")])
def test_a_span_belongs_to_the_longest_layer_it_names(name, layer):
    assert profiling._layer(name) == layer


def test_idle_is_split_exactly_by_the_spans_it_crosses():
    # kernels at 250-300, 420-440, 600-650: idle 0-250 (outside to 100,
    # then the detector), 300-420 crossing detector -> em, 440-600 in
    # the em, 650-1000 (em to 800, then outside)
    rec = profiling.Record()
    rec.read(_events(HOST, [(250, 300, 1), (420, 440, 2), (600, 650, 3)],
                     [(150, 1), (390, 2), (450, 3)]))
    (b,) = rec.batches
    assert b["idle_ms"] == pytest.approx(
        {"outside": 100 + 200, "vp.detector": 150 + 100,
         "vp.em": 20 + 160 + 150})
    assert rec.idle_ms == pytest.approx(880) and rec.busy_ms == 120
    assert b["span_ms"]["vp.em"] == 400 and b["spans"]["vp.em.iteration"] \
        == 1


def test_a_kernel_is_charged_at_its_launch_not_its_start():
    # launched inside the detector (at 150 and 390), run while the host
    # is in the em; the third, launched in an em iteration, is the em's
    rec = profiling.Record()
    rec.read(_events(HOST, [(250, 300, 1), (420, 440, 2), (600, 650, 3)],
                     [(150, 1), (390, 2), (470, 3)]))
    (b,) = rec.batches
    assert rec.unlaunched == 0
    assert b["busy_ms"] == pytest.approx({"vp.detector": 70, "vp.em": 50})
    assert b["launches"] == {"vp.detector": 2, "vp.em": 1}


def test_an_op_without_its_launch_call_is_charged_outside():
    rec = profiling.Record()
    rec.read(_events(HOST, [(250, 300, 1), (600, 650, 3)], [(150, 1)]))
    (b,) = rec.batches
    assert rec.unlaunched == 1 and rec.device_ops == 2
    assert b["launches"] == {"vp.detector": 1, "outside": 1}


def test_each_batch_owns_the_stretch_up_to_its_end():
    # two batches; the copy before the second and the readback after the
    # first fall in the second's stretch, the tail in the last's
    host = [("vp.session", 0, 100), ("vp.batch", 10, 40),
            ("vp.em", 10, 40), ("vp.batch", 60, 90), ("vp.em", 60, 90)]
    rec = profiling.Record()
    rec.read(_events(host, [(45, 55, 1)], [(42, 1)]))
    b0, b1 = rec.batches
    assert b0["idle_ms"] == pytest.approx({"outside": 10, "vp.em": 30})
    assert b1["idle_ms"] == pytest.approx({"outside": 10 + 10, "vp.em": 30})
    assert b1["launches"] == {"outside": 1} and b0["launches"] == {}
    assert rec.idle_ms == pytest.approx(90)


def test_trace_writes_a_chrome_trace_of_the_spans(traced, tmp_path):
    pipe = traced["pipe"]
    with profiling.trace(str(tmp_path / "run")) as rec:
        tpipe.device_pipeline_full(traced["imgs"][:1], pipe.model, pipe.mean,
                                   CFG)
    with open(tmp_path / "run" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert LAYER_SPANS | {"vp.batch", "vp.detector.ccl"} <= names
    assert len(rec.batches) == 1


def test_counts_held_back_stay_out_of_the_session():
    """Counts made inside ``held()`` (a CUDA graph's capture), counters
    and tallies (a kernel's count of its launches), reach its list only,
    in a session or not; the caller makes them again, once a replay."""
    tallied = []
    with profiling.trace() as rec:
        profiling.count("a")
        with profiling.held() as held:
            profiling.count("a", 2)
            profiling.count("b")
            profiling.tally(lambda: tallied.append(1))
        assert not tallied
        for _ in range(2):
            for again in held:
                again()
    assert rec.counters == {"a": 5, "b": 2} and tallied == [1, 1]
    with profiling.held() as off:
        profiling.count("c")
    assert len(off) == 1 and profiling._held is None
    profiling.tally(lambda: tallied.append(1))
    assert tallied == [1, 1, 1]


def test_sessions_do_not_nest():
    with profiling.trace():
        with pytest.raises(RuntimeError):
            with profiling.trace():
                pass
    assert profiling._session is None


class _Event:
    """A kineto event as torch 2.11 gives it: no ``activity_type``."""

    def __init__(self, name, device, user=False, start=0, corr=0):
        self._n, self._d, self._u, self._s, self._c = (name, device, user,
                                                       start, corr)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._u

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return 10

    def correlation_id(self):
        return self._c


def test_events_without_activity_types_are_told_apart():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [_Event("vp.em", cpu, True, 0, 7), _Event("vp.em", cuda, True, 5, 7),
          _Event("cudaLaunchKernel", cpu, False, 2, 9),
          _Event("cuLaunchKernelEx", cpu, False, 3, 11),
          _Event("Activity Buffer Request", cpu),
          _Event("void at::native::reduce_kernel", cuda, False, 6, 9),
          _Event("Memcpy DtoH (Device -> Pinned)", cuda, False, 8, 11)]
    # the span and the kernel share an id by chance: only a launch call's
    # id names a kernel; the span's copy on the device is dropped
    assert [k for k, *_ in profiling.events_of(ev)] == [
        "span", "launch", "launch", "other", "device", "device"]
    rec = profiling.Record()
    rec.read(profiling.events_of(ev))
    assert rec.device_ops == 2 and rec.unlaunched == 0


@pytest.mark.gpu
def test_a_traced_batch_on_the_card():
    """One batch of 32 at 640 x 640 under the trace session on the card:
    every device op charged to a layer span or to ``outside``, the EM's
    host reads as the monkey-patched count has them, outputs unchanged
    (``chip_smoke.tracing_phase`` raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import SCENES, tracing_phase
    from vanishing_points_2017_tpu_torch.weights import load_params_and_mean

    params, mean = load_params_and_mean()
    pipe = tpipe.Pipeline(params, mean, tpipe.PipelineConfig())
    grays = [tpipe.Pipeline.ingest_image(p)["gray"] for p in SCENES]
    imgs = torch.from_numpy(np.stack(grays * 8)).cuda()
    res = tracing_phase(pipe, imgs)
    assert res["em_host_reads"] > 0 and res["em_trips"] > 0
    assert res["em_launches"] > 0


@pytest.mark.gpu
def test_k3_launches_are_counted_per_split_on_the_card():
    """A batch of the benchmark cell ``sd640_scenes_b32``, which splits,
    under the trace session, its EM's graphs captured before: the EM's
    count of K3's launches (``em.cluster_launches``) equals the kernel's
    own and the split stretches replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import cell_batch, recording
    from vanishing_points_2017_tpu_torch.em import cluster

    step, batch = cell_batch(torch.device("cuda"))
    step(batch)["hp1"].cpu()
    before = cluster.CLUSTER_KERNEL.launches
    with profiling.trace() as rec, \
            recording(tem._Driver, "run", clone=False) as runs:
        step(batch)["hp1"].cpu()
    splits = [r for r in runs if r[1] == "split"]
    assert splits and len(rec.batches) == 1
    assert rec.batches[0]["counters"].get("em.cluster_launches") == \
        len(splits) == cluster.CLUSTER_KERNEL.launches - before
