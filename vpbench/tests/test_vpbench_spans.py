"""CPU tests of the readers of the port's spans and counters
(``vpbench/spans.py``): the per-batch numbers and their medians from a
hand-built session record, the readers found by name after the ten
earlier ones, and nothing to read off the card or from a program
without spans."""

import json
import os
from types import SimpleNamespace

import pytest

from vanishing_points_2017_tpu_torch.utils import profiling
from vpbench import run, spans

NEW = ["detector_span_ms", "render_span_ms", "cnn_span_ms", "em_span_ms",
       "horizon_span_ms", "detector_idle_ms", "em_idle_ms",
       "outside_idle_ms", "em_trips", "em_launches", "em_host_reads"]
MS = 1_000_000


def _record():
    """Two batches on a hand-built timeline (1 unit = 1 ms): the second
    batch's EM twice as long, with two more iterations and launches."""
    ev = [("span", "vp.session", 0, 400 * MS, 0)]
    corr = 0
    for b0, em_end, trips in ((0, 100, 1), (200, 300, 3)):
        ev += [("span", "vp.batch", (b0 + 10) * MS, (em_end + 20) * MS, 0),
               ("span", "vp.detector", (b0 + 10) * MS, (b0 + 30) * MS, 0),
               ("span", "vp.em", (b0 + 40) * MS, em_end * MS, 0),
               ("span", "vp.horizon", em_end * MS, (em_end + 10) * MS, 0)]
        for k in range(trips):
            t = b0 + 40 + 10 * k
            ev.append(("span", "vp.em.iteration", t * MS, (t + 5) * MS, 0))
            corr += 1
            ev += [("launch", "cudaLaunchKernel", (t + 1) * MS,
                    (t + 1) * MS + 1, corr),
                   ("device", "k", (t + 2) * MS, (t + 4) * MS, corr)]
    rec = profiling.Record()
    session = SimpleNamespace(batches=[{"em.host_reads": 4},
                                       {"em.host_reads": 10}], loose={})
    rec.read(ev, session)
    return rec


def test_per_batch_numbers_and_their_medians():
    s = spans.summarize(_record())
    assert s["batches"] == 2 and s["unlaunched"] == 0
    assert s["em_span_ms"] == pytest.approx((60 + 60) / 2)
    assert s["detector_span_ms"] == pytest.approx(20)
    assert s["em_trips"] == 2 and s["em_launches"] == 2
    assert s["em_host_reads"] == 7
    assert s["em_busy_ms"] == pytest.approx((2 + 6) / 2)
    # the EM's idle is its span less its kernels; outside: the rest
    assert s["em_idle_ms"] == pytest.approx((58 + 54) / 2)
    assert s["attributed_idle_ms"] == pytest.approx(s["idle_ms"])
    assert s["idle_ms"] == pytest.approx(400 - 8)


def test_new_readers_follow_the_ten_earlier_ones():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == NEW and len(names) == 10 + len(NEW)
    for m in bench["per_layer"][-len(NEW):]:
        assert m["moves"] == "images_per_s" and m["better"] == "lower"
        assert m["workloads"] == ["sd640_scenes_b32"]
    wl = {"name": "sd640_scenes_b32"}
    assert [m["name"] for m in run.cell_metrics(bench, wl, True)] == names


def test_readers_read_the_pass_once():
    tr = SimpleNamespace(on_card=True, _spans_pass=spans.summarize(
        _record()))
    assert run.reader("em_trips")(tr) == 2
    assert run.reader("em_host_reads")(tr) == 7
    assert run.reader("outside_idle_ms")(tr) == pytest.approx(
        tr._spans_pass["outside_idle_ms"])


def test_nothing_to_read_off_the_card_or_without_spans(monkeypatch):
    for name in NEW:
        assert run.reader(name)(SimpleNamespace(on_card=False)) is None
    # a program without the port's tracing (the parent of this reader)
    monkeypatch.delattr(profiling, "Record")
    tr = SimpleNamespace(on_card=True)
    assert run.reader("em_span_ms")(tr) is None
    assert tr._spans_pass is None


def test_the_pass_runs_the_stretch_the_trace_carries(monkeypatch):
    import contextlib

    import torch

    @contextlib.contextmanager
    def session():
        yield _record()

    monkeypatch.setattr(profiling, "trace", session)
    sent = []
    tr = run.Trace({}, {}, torch.device("cuda"), {}, {}, sent.append, 3,
                   [0.5, 0.25, 0.125, 4.0])
    assert run.reader("em_trips")(tr) == 2
    assert sent == [0, 1, 2]
    assert tr._spans_pass["paced_s"] == pytest.approx(0.875)
    # read once: the other readers take the same pass
    assert run.reader("em_host_reads")(tr) == 7 and sent == [0, 1, 2]
