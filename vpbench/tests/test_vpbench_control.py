"""The checks of ``correct`` fail where they should, at sizes a CPU test
holds: the control (the reference one precision step below what the
configuration states, in the program's place) comes out not correct, and
a run whose timed path is broken underneath comes out not correct, once
for each fault a cell can have. (The cells run on one card, so there is
no exchange between cards to leave out.) A sound run of the same size
comes out correct."""

import copy

import pytest
import torch

from vpbench import calibrate, run

CELL = "sd640_scenes_b32"
# the cell's images, and the same scenes' segments through the lines entry
INPUTS = ("images", "lines")


def _small(inputs: str):
    bench, wl, config, traffic = run.load_cell(CELL)
    config = copy.deepcopy(config)
    config["image"] = {"width": 160, "height": 128}
    traffic = dict(traffic, batch=2, pool=2, inputs=inputs)
    return bench, wl, config, traffic


@pytest.mark.parametrize("inputs", INPUTS)
def test_the_control_is_not_correct(inputs):
    _, _, config, traffic = _small(inputs)
    recs = calibrate.readings(CELL, [2 ** 31 + 17], True, "cpu", config,
                              traffic)
    by_side = {r["side"]: r for r in recs}
    assert by_side["program"]["correct"]
    assert not by_side["control"]["correct"]


def _em_state_unchanged(monkeypatch):
    from vanishing_points_2017_tpu_torch.em import em

    def unchanged(st, ctx, with_split_merge=True):
        return st._replace(done=torch.ones_like(st.done))

    monkeypatch.setattr(em, "_iteration", unchanged)


def _half_batch(monkeypatch):
    from vanishing_points_2017_tpu_torch import pipeline

    def halve(fn):
        def broken(*args):
            b = args[0].shape[0]
            h = max(1, b // 2)
            out = fn(*(a[:h] for a in args[:-3]), *args[-3:])
            idx = torch.arange(b) % h
            return {k: v[idx] for k, v in out.items()}
        return broken

    monkeypatch.setattr(pipeline, "device_pipeline_full",
                        halve(pipeline.device_pipeline_full))
    monkeypatch.setattr(pipeline, "device_pipeline_batch",
                        halve(pipeline.device_pipeline_batch))


def _answer_altered(monkeypatch):
    from vanishing_points_2017_tpu_torch.em import consensus

    orig = consensus.calculate_horizon_and_ortho_vp

    def altered(*a, **k):
        hp1, *rest = orig(*a, **k)
        hp1 = hp1.clone()
        hp1[0, 1] += 0.01
        return (hp1, *rest)

    monkeypatch.setattr(consensus, "calculate_horizon_and_ortho_vp", altered)


FAULTS = {"em_state_unchanged": _em_state_unchanged,
          "half_batch_left_out": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_timed_path_is_not_correct(inputs, fault, monkeypatch):
    bench, wl, config, traffic = _small(inputs)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    rec = run.run(bench, wl, config, traffic, 2 ** 31 + 29, 0.2, False,
                  device="cpu")
    assert rec["correct"] == (fault is None), rec["checks"]
    assert list(rec)[-1] == "checks"
