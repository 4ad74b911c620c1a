"""CPU tests of the training cell at a tiny size: the ``train`` job
through the harness (build, warm-up, steps, keep, judge), the control
and five faults underneath the timed step read not correct, the frozen
copy of the training scenes, the step's counts written out by hand, the
readers, and a program without the device step failing at once.

The network keeps the published layer kinds at narrow widths on 99 x 99
inputs; its weights are seeded random from the prototxt's fillers, given
in place of the configuration's file (``vpbench.weights.load``)."""

import copy

import numpy as np
import pytest
import torch

from vpbench import calibrate_train, run, train_counts, train_scenes, weights

CELL = "train500_b32"
SIZE = 99
WIDTHS = [8, 8, 12, 12, 8]  # conv1..conv5; fc6 and fc7 16


def _params(seed: int = 0) -> tuple:
    g = torch.Generator().manual_seed(seed)
    p, cin = {}, 1
    for (name, groups, k), out in zip(
            [("conv1", 1, 11), ("conv2", 2, 5), ("conv3", 1, 3),
             ("conv4", 2, 3), ("conv5", 2, 3)], WIDTHS):
        p[name] = {"w": torch.randn(out, cin // groups, k, k, generator=g)
                   * 0.01,
                   "b": torch.full((out,), 0.0 if name in ("conv1", "conv3")
                                   else 0.1)}
        cin = out
    din = cin * 2 * 2
    for name, out in (("fc6", 16), ("fc7", 16), ("fc8_20x20", 400)):
        std, bias = (0.01, 0.0) if name == "fc8_20x20" else (0.005, 0.1)
        p[name] = {"w": torch.randn(din, out, generator=g) * std,
                   "b": torch.full((out,), bias)}
        din = out
    mean = 40.0 + 20.0 * torch.rand(SIZE, SIZE, generator=g)
    return p, mean


@pytest.fixture
def tiny(monkeypatch):
    """The cell at the tiny size: (bench, workload, config, traffic)."""
    def load(config, root, dev):
        p, mean = _params()
        return ({n: {k: v.to(dev) for k, v in d.items()}
                 for n, d in p.items()}, mean.to(dev))

    monkeypatch.setattr(weights, "load", load)
    bench, wl, config, traffic = run.load_cell(CELL)
    config = copy.deepcopy(config)
    net = config["network"]
    net["input"] = SIZE
    net["convs"] = [[n, w, *rest] for (n, _, *rest), w in
                    zip(net["convs"], WIDTHS)]
    net["fc"] = [["fc6", 16], ["fc7", 16], ["fc8_20x20", 400]]
    return bench, wl, config, dict(traffic, batch=3, pool=4, judged=2,
                                   n_pad=256)


def test_the_cell_is_the_published_network_and_solver():
    bench, wl, config, traffic = run.load_cell(CELL)
    assert wl["chips"] == 1 and traffic["job"] == "train"
    assert config["reduced"] == [] and config["network"]["fc"] == [
        ["fc6", 4096], ["fc7", 4096], ["fc8_20x20", 400]]
    assert config["solver"]["momentum"] == 0.9
    assert config["solver"]["weight_decay"] == 5e-4
    assert (config["solver"]["lr_mult"], config["solver"]["decay_mult"]) \
        == ([1, 2], [1, 0])
    serve = run.load_cell("sd640_scenes_b32")[2]
    for k in ("network", "weights", "weights_fingerprint", "mean"):
        assert config[k] == serve[k]
    assert [m["name"] for m in run.cell_metrics(bench, wl, False)] == [
        "images_per_s", "setup_s"]
    assert [m["name"] for m in run.cell_metrics(bench, wl, True)] == [
        "train_input_span_ms", "train_forward_span_ms",
        "train_backward_span_ms", "train_update_span_ms", "train_idle_ms",
        "train_mfu", "train_update_roofline"]


def test_the_job_builds_steps_keeps_and_judges(tiny):
    _, _, config, traffic = tiny
    seed = 2 ** 31 + 5
    marks = []
    work = run.job("train").build(config, traffic, seed, torch.device("cpu"),
                                  run.ROOT, marks.append)
    assert marks == ["import", "kernels", "weights", "pool"]
    assert (work.order, work.steps_judged) == run.window_order(traffic, seed)
    assert work.judged == sorted(set(work.steps_judged) | {
        j - 1 for j in work.steps_judged if j > 0})
    assert work.items == 3
    work.warm_up()
    assert work.state.step == 3
    kept = []
    for i in range(work.judged[-1] + 1):
        out = work.step(i)
        assert out.images.shape == (3, 1, SIZE, SIZE)
        if i in work.judged:
            k = work.keep(i, out)
            kept.append(k)
            assert ("loss" in k) == (i in work.steps_judged)
            assert ("theta_next" in k) == (i + 1 in work.steps_judged)
    assert work.state.step == 3 + work.judged[-1] + 1
    judged = [k for k in kept if "loss" in k]
    assert [k["step"] for k in judged] == [3 + j for j in work.steps_judged]
    assert [k["batch"] for k in judged] == [work.order[j]
                                            for j in work.steps_judged]
    work.free()
    numbers = work.judge(kept)
    assert list(numbers) == ["image_off", "loss_off", "step_off",
                             "theta_off"]
    # the same operations on the CPU: the step term parts only by float32
    # rounding of momentum * V_before - V_after, and the new momentum
    # (theta_off) lies within that rounding of the increments that give
    # the parameters the program kept
    assert numbers["image_off"] == 0 and numbers["loss_off"] == 0
    assert numbers["step_off"] < 1e-5 and numbers["theta_off"] < 1e-5


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_training_cell_gives_every_key(tiny, trace):
    bench, wl, config, traffic = tiny
    rec = run.run(bench, wl, config, traffic, 2 ** 31 + 7, 0.2, trace,
                  device="cpu")
    assert list(rec) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] % 3 == 0 and rec["attempted"] >= 3
    assert list(rec["checks"]) == ["image_off", "loss_off", "step_off",
                                   "theta_off"]
    if not trace:
        assert list(rec["metrics"]) == ["images_per_s", "setup_s"]
    else:
        # off the card only the host clock's share: the spans need it
        assert list(rec["metrics"]) == ["train_mfu"]


def test_the_control_is_not_correct(tiny):
    _, _, config, traffic = tiny
    recs = calibrate_train.readings(CELL, [2 ** 31 + 17], True, "cpu",
                                    config, traffic)
    by_side = {r["side"]: r for r in recs}
    assert by_side["program"]["correct"], by_side["program"]
    assert not by_side["control"]["correct"], by_side["control"]
    # a sound bfloat16 step summed in another order stays inside
    assert by_side["blocked"]["correct"], by_side["blocked"]


def _biases_at_1x(monkeypatch):
    from vanishing_points_2017_tpu_torch.models import train

    sgd = train.sgd_update

    def once_rate(params, grads, momentum, step, base_lr=train.BASE_LR,
                  lr_stepsize=train.LR_STEPSIZE):
        for bias in (False, True):
            part = {n: {k: v for k, v in d.items() if (k == "b") == bias}
                    for n, d in params.items()}
            sgd(part, grads, momentum, step,
                base_lr / 2 if bias else base_lr, lr_stepsize)

    monkeypatch.setattr(train, "sgd_update", once_rate)


def _fc7_mask_ignored(monkeypatch):
    from vanishing_points_2017_tpu_torch.models import cnn

    logits = cnn.VPNet.logits

    def every_unit_kept(self, x, keep=None):
        if keep is not None:
            keep = [keep[0], torch.ones_like(keep[1])]
        return logits(self, x, keep)

    monkeypatch.setattr(cnn.VPNet, "logits", every_unit_kept)


def _mean_not_subtracted(monkeypatch):
    from vanishing_points_2017_tpu_torch.models import train

    render = train.render_images

    def no_mean(lines, lmask, mean=None, size=500):
        return render(lines, lmask, None, size)

    monkeypatch.setattr(train, "render_images", no_mean)


def _momentum_dropped(monkeypatch):
    from vanishing_points_2017_tpu_torch.models import train

    sgd = train.sgd_update

    def no_momentum(params, grads, momentum, *a, **k):
        for d in momentum.values():
            for v in d.values():
                v.zero_()
        sgd(params, grads, momentum, *a, **k)

    monkeypatch.setattr(train, "sgd_update", no_momentum)


def _parameters_not_moved(monkeypatch):
    """The momentum updated, theta <- theta + V left out."""
    from vanishing_points_2017_tpu_torch.models import train

    sgd = train.sgd_update

    def momentum_only(params, grads, momentum, *a, **k):
        was = {n: {key: v.detach().clone() for key, v in d.items()}
               for n, d in params.items()}
        sgd(params, grads, momentum, *a, **k)
        with torch.no_grad():
            for n, d in params.items():
                for key, v in d.items():
                    v.copy_(was[n][key])

    monkeypatch.setattr(train, "sgd_update", momentum_only)


FAULTS = {"biases_at_1x_lr": _biases_at_1x,
          "fc7_mask_ignored": _fc7_mask_ignored,
          "mean_not_subtracted": _mean_not_subtracted,
          "momentum_dropped": _momentum_dropped,
          "parameters_not_moved": _parameters_not_moved}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_training_step_is_not_correct(tiny, fault, monkeypatch):
    bench, wl, config, traffic = tiny
    if fault is not None:
        FAULTS[fault](monkeypatch)
    rec = run.run(bench, wl, config, traffic, 2 ** 31 + 29, 0.1, False,
                  device="cpu")
    assert rec["correct"] == (fault is None), rec["checks"]


def test_theta_off_measures_the_momentum_against_float32_addition():
    job = run.job("train")
    theta = torch.tensor([1.0, 1.0, 0.0, 1.0], dtype=torch.float32)
    ulp = 2.0 ** -23  # float32's step just above 1
    # an increment lost in the addition, one that lands, one below zero's
    # step, and the parameter left where it was against a step of 4 ulp
    v = torch.tensor([ulp / 4, 3 * ulp, 1e-30, 4 * ulp], dtype=torch.float64)
    after = (theta.double() + v).float()
    after[3] = theta[3]
    off = job._off_increments(theta, after, v)
    assert off[:3].tolist() == [0.0, 0.0, 0.0]
    # the nearest increment that leaves 1.0 where it was is half an ulp
    assert off[3].item() == -3.5 * ulp
    # the increments that give theta_after lie between the boundaries
    # halfway to its float32 neighbours (1 + ulp above, 1 - ulp / 2
    # below): their ends read 0, beyond them the distance to the nearer
    a = torch.tensor([1.0], dtype=torch.float32)
    for v, want in ((ulp / 2, 0.0), (-ulp / 4, 0.0), (ulp, -ulp / 2),
                    (-ulp, 3 * ulp / 4)):
        assert job._off_increments(a, a, torch.tensor(
            [v], dtype=torch.float64)).item() == want


@pytest.mark.parametrize("seed", range(20))
def test_the_frozen_scenes_are_the_ports(seed):
    from vanishing_points_2017_tpu_torch.models import synth

    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        mine, port = train_scenes.make_training_scene(a), \
            synth.make_training_scene(b)
        for f in ("segments", "lines", "vps", "vp_assoc", "horizon"):
            assert np.array_equal(getattr(mine, f), getattr(port, f)), f
        assert np.array_equal(train_scenes.vp_grid_label(mine.vps),
                              synth.vp_grid_label(port.vps))


def test_the_pool_is_the_ports_draw_batch():
    from vanishing_points_2017_tpu_torch.models import train

    traffic = {"pool": 2, "batch": 3, "n_pad": 64}
    pool = train_scenes.draw_pool(traffic, 11)
    rng = np.random.default_rng(11)
    for k in range(2):
        want = train.draw_batch(rng, 3, 64)
        for got, w in zip(pool.batch(k), want):
            assert torch.equal(got, w)


def test_the_counts_written_out_by_hand():
    net = run.load_cell(CELL)[2]["network"]
    # forward, 2 per multiply-add: conv k*k*(in/groups)*out*side^2 on
    # conv1's 123 grid, pooled (ceil) to 61 for conv2, to 30 for conv3-5,
    # to 15 for fc6; fc in*out
    convs = [2 * 11 * 11 * 1 * 96 * 123 ** 2, 2 * 5 * 5 * 48 * 256 * 61 ** 2,
             2 * 3 * 3 * 256 * 384 * 30 ** 2, 2 * 3 * 3 * 192 * 384 * 30 ** 2,
             2 * 3 * 3 * 192 * 256 * 30 ** 2]
    fcs = [2 * 256 * 15 * 15 * 4096, 2 * 4096 * 4096, 2 * 4096 * 400]
    forward = sum(convs) + sum(fcs)
    assert forward == 6_729_530_560
    assert train_counts.train_flops_per_image(net) == 3 * forward - convs[0]
    assert train_counts.train_flops_per_image(net) == 19_837_114_752
    params = (11 * 11 * 96 + 96 + 5 * 5 * 48 * 256 + 256
              + 3 * 3 * 256 * 384 + 384 + 3 * 3 * 192 * 384 + 384
              + 3 * 3 * 192 * 256 + 256 + 57600 * 4096 + 4096
              + 4096 * 4096 + 4096 + 4096 * 400 + 400)
    assert train_counts.n_params(net) == params == 256_664_656
    assert train_counts.update_bytes(net) == 20 * params


def test_the_readers_give_nothing_off_the_card():
    from types import SimpleNamespace

    spans = {"input_span_ms": 1.0, "forward_span_ms": 2.0,
             "backward_span_ms": 3.0, "update_span_ms": 4.0,
             "idle_ms": 0.5, "update_busy_ms": 4.0}
    net = run.load_cell(CELL)[2]["network"]
    for on_card in (False, True):
        tr = SimpleNamespace(on_card=on_card, config={"network": net},
                             window={"images_per_s": 1000.0},
                             train_span=spans.get)
        got = {m: run.reader(m)(tr) for m in (
            "train_input_span_ms", "train_forward_span_ms",
            "train_backward_span_ms", "train_update_span_ms",
            "train_idle_ms", "train_mfu", "train_update_roofline")}
        assert got["train_mfu"] == pytest.approx(
            100 * 19_837_114_752 * 1000 / 989e12)
        if not on_card:
            assert [k for k, v in got.items() if v is not None] == [
                "train_mfu"]
            continue
        assert got["train_input_span_ms"] == 1.0
        assert got["train_update_span_ms"] == 4.0
        assert got["train_idle_ms"] == 0.5
        assert got["train_update_roofline"] == pytest.approx(
            100 * 20 * 256_664_656 / 3.35e12 / 4e-3)


def test_a_program_without_the_device_step_fails_at_once(tiny, monkeypatch):
    from vanishing_points_2017_tpu_torch.models import train

    monkeypatch.delattr(train, "device_step")
    bench, wl, config, traffic = tiny
    with pytest.raises(AttributeError, match="device_step"):
        run.run(bench, wl, config, traffic, 3, 0.1, False, device="cpu")


def test_a_trace_session_gives_one_row_per_device_step():
    from vanishing_points_2017_tpu_torch.models import train
    from vanishing_points_2017_tpu_torch.utils import profiling

    p, mean = _params()
    state = train.init_state(p)
    rng = np.random.default_rng(3)
    with profiling.trace() as rec:
        for _ in range(2):
            lines, lmask, labels = train.draw_batch(rng, 2, 64)
            train.device_step(state, lines, lmask, labels, mean, 5,
                              SIZE).loss.item()
    assert len(rec.batches) == 2
    for b in rec.batches:
        assert b["spans"] == {"vp.batch": 1, "vp.train.input": 1,
                              "vp.train.forward": 1, "vp.train.backward": 1,
                              "vp.train.update": 1}
    s = run.job("train").spans_summary(rec)
    assert s["steps"] == 2 and s["spans"] == 4
    assert all(s[f"{k}_span_ms"] > 0
               for k in ("input", "forward", "backward", "update"))


MS = 1_000_000


def test_training_spans_are_layers_and_serving_attribution_stands():
    """A serving batch and a training step on one hand-built timeline
    (1 unit = 1 ms): each kernel is charged to the innermost layer open
    at its launch, serving's sub-spans to their layer as before."""
    from types import SimpleNamespace

    from vanishing_points_2017_tpu_torch.utils import profiling

    ev = [("span", "vp.session", 0, 100 * MS, 0),
          ("span", "vp.batch", 0, 40 * MS, 0),
          ("span", "vp.detector", 0, 10 * MS, 0),
          ("span", "vp.detector.ccl", 2 * MS, 8 * MS, 0),
          ("span", "vp.em", 10 * MS, 30 * MS, 0),
          ("span", "vp.em.iteration", 12 * MS, 20 * MS, 0),
          ("span", "vp.batch", 50 * MS, 90 * MS, 0),
          ("span", "vp.train.input", 50 * MS, 55 * MS, 0),
          ("span", "vp.train.forward", 55 * MS, 65 * MS, 0),
          ("span", "vp.train.backward", 65 * MS, 80 * MS, 0),
          ("span", "vp.train.update", 80 * MS, 88 * MS, 0)]
    launches = {"vp.detector": 3, "vp.em": 14, "outside": 35,
                "vp.train.input": 51, "vp.train.forward": 60,
                "vp.train.backward": 70, "vp.train.update": 81}
    for c, (lay, t) in enumerate(launches.items(), 1):
        ev += [("launch", "cudaLaunchKernel", t * MS, t * MS + 1, c),
               ("device", "k", (t + 1) * MS, (t + 2) * MS, c)]
    rec = profiling.Record()
    rec.read(ev, SimpleNamespace(batches=[{}, {}], loose={}))
    serve, step = rec.batches
    assert serve["busy_ms"] == {"vp.detector": 1.0, "vp.em": 1.0,
                                "outside": 1.0}
    assert step["busy_ms"] == {k: 1.0 for k in (
        "vp.train.input", "vp.train.forward", "vp.train.backward",
        "vp.train.update")}
    assert step["idle_ms"]["vp.train.backward"] == pytest.approx(14.0)
    assert sum(serve["idle_ms"].values()) + sum(step["idle_ms"].values()) \
        == pytest.approx(rec.idle_ms)
