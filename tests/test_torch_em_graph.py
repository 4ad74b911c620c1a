"""The EM's loop with split and merge gated from the host's trip count,
and its stretches (the device work between two host reads) replayed as
captured CUDA graphs (``em/em.py``: ``_full_trip``, ``_Driver``).

On the CPU: the lockstep the host's gate rests on (every image still
running at trip t is at iteration t), the gate against the body's own
per-image gates, the loop bit for bit against an oracle that runs the
full body on every trip (the loop before the gate), and the graph path's
bookkeeping (buffers, copies in and out, the cache, the counters, every
stretch in every configuration) rehearsed with the capture replaced by a
plain call of the captured step. Marked ``gpu``: the same on the card
with the real capture, run there (no JAX on that machine) with

    python -m pytest --noconftest tests/test_torch_em_graph.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch.em import em as tem
from vanishing_points_2017_tpu_torch.em import cluster as tcluster
from vanishing_points_2017_tpu_torch.em.horizon import \
    calculate_horizon_and_ortho_vp
from vanishing_points_2017_tpu_torch.models import synth
from vanishing_points_2017_tpu_torch.ops import sphere
from vanishing_points_2017_tpu_torch.pipeline import pad_lines
from vanishing_points_2017_tpu_torch.utils import profiling
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POPULATIONS = os.path.join(ROOT, "assets", "examples", "jax_reference_em.npz")
SAME = dict(rtol=0, atol=0, equal_nan=True)


def bench_scenes(b: int, n_pad: int = 256, seed: int = 0,
                 noise: float = 0.02, sphere_size: int = 240,
                 device: str = "cpu") -> list:
    """EM inputs (l, lp, grid, sphere, lmask) of ``b`` scenes drawn as the
    port's bench draws them (``bench.make_inputs``: 30-60 lines per VP,
    10-30 outliers), with segment noise, the idealized CNN grid and the
    sphere image of the lines, stacked on ``device``."""
    rng = np.random.default_rng(seed)
    ls, lps, grids, masks = [], [], [], []
    for _ in range(b):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(30, 60)),
                                 outliers=int(rng.integers(10, 30)),
                                 noise=noise)
        l, lp, m = pad_lines(scene.segments, n_pad)
        ls.append(l), lps.append(lp), masks.append(m)
        grids.append(synth.vp_grid_label(scene.vps).astype(np.float32))
    l, lp, grid, m = (torch.from_numpy(np.stack(a)).to(device)
                      for a in (ls, lps, grids, masks))
    img = sphere.sphere_image_uint8(l, m, size=sphere_size).float()
    return [l, lp, grid, img, m]


def populations(rows=slice(None)) -> list:
    """The 21 segment populations of the EM trajectory oracle (JAX's
    lines, sphere image and grid), stacked."""
    ref = np.load(POPULATIONS)
    t = lambda k: torch.from_numpy(np.ascontiguousarray(ref[k][rows]))
    return [t("l"), t("lp"), t("grid"), t("sphere").float(), t("lmask")]


def oracle(args, cfg, on_trip=None) -> tem.EMResult:
    """The loop before the host's gate: the full body on every trip.
    ``on_trip(t, st)`` sees the state at the start of each trip, and
    ``st`` None at the loop's end."""
    st, ctx = tem._setup(*args, cfg)
    t = 0
    while not bool(st.done.all()):
        if on_trip is not None:
            on_trip(t, st)
        st = tem._iteration(st, ctx)
        t += 1
    if on_trip is not None:
        on_trip(t, None)
    return tem._Driver(tem._ns_of(st, ctx)).finalize()


def assert_same(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, **SAME)


# ---- the CPU: lockstep, the gate, the loop against the oracle


@pytest.fixture(scope="module")
def scenes():
    return bench_scenes(6)


def record(args, cfg) -> dict:
    """The oracle's run with, per trip, whether the running images are
    all at iteration t, whether one of them still has a VP, and whether a
    split or merge was due (``split_due.any() | merge_due.any()``, seen
    as a gate's host read that held); and the loop's result on the same
    inputs."""
    trips, calls = [], []
    with pytest.MonkeyPatch.context() as m:
        def read(em, flag, _orig=tem._Driver.read):
            got = _orig(em, flag)
            if got and flag in ("split_any", "merge_any"):
                calls.append(flag)
            return got

        m.setattr(tem._Driver, "read", read)

        def on_trip(t, st):
            if trips:
                trips[-1]["due"] = bool(calls)
            calls.clear()
            if st is None:
                return
            run = ~st.done
            trips.append(dict(t=t, lockstep=bool((st.i[run] == t).all()),
                              running=bool((run & (st.alive.sum(dim=1)
                                                   > 0)).any())))

        want = oracle(args, cfg, on_trip)
    return dict(trips=trips, oracle=want,
                loop=tem.expectation_maximisation(*args, cfg))


@pytest.fixture(scope="module")
def runs(scenes):
    """(inputs, split_merge_freq) -> :func:`record`, each made once."""
    inputs = {"scenes": lambda: scenes, "populations": populations}
    memo = {}

    def get(name, freq):
        if (name, freq) not in memo:
            memo[name, freq] = record(inputs[name](), tem.EMConfig(
                split_merge_freq=freq))
        return memo[name, freq]

    return get


@pytest.mark.parametrize("name", ["scenes", "populations"])
def test_running_images_are_at_the_trip_count(name, runs):
    """Every image not done at the start of trip t has i == t."""
    trips = runs(name, 10)["trips"]
    assert len(trips) > 10 and all(r["lockstep"] for r in trips)


# the populations (B = 21, N = 512) at split_merge_freq 3 take ~50 s on one
# CPU thread, so they run at 10 only
CASES = [("scenes", 3), ("scenes", 10), ("populations", 10)]


@pytest.mark.parametrize("name,freq", CASES)
def test_full_trips_are_the_trips_with_a_split_or_merge_due(name, freq,
                                                            runs):
    """``_full_trip(t)`` against the body's own gates: a split or merge
    is due on a trip exactly where the host says full and some running
    image still has a VP."""
    cfg = tem.EMConfig(split_merge_freq=freq)
    trips = runs(name, freq)["trips"]
    full = [r["t"] for r in trips if tem._full_trip(r["t"], cfg)]
    assert full and len(full) < len(trips)
    for r in trips:
        assert r["due"] == (tem._full_trip(r["t"], cfg) and r["running"]), r


@pytest.mark.parametrize("name,freq", CASES)
def test_loop_is_bit_identical_to_the_full_body_oracle(name, freq, runs):
    run = runs(name, freq)
    assert_same(run["loop"], run["oracle"])


def test_full_trip_gate_follows_the_configuration():
    cfg = tem.EMConfig()
    assert [t for t in range(120) if tem._full_trip(t, cfg)] == [
        10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110]
    off = dataclasses.replace(cfg, do_merge=False)
    assert [t for t in range(120) if tem._full_trip(t, off)][-1] == 90
    none = dataclasses.replace(cfg, do_merge=False, do_split=False)
    assert not any(tem._full_trip(t, none) for t in range(120))
    assert not any(tem._full_trip(t, dataclasses.replace(
        cfg, split_merge_freq=0)) for t in range(120))


# ---- the graph path's bookkeeping on the CPU, the capture a plain call


class Reads:
    """On either path (``em._Driver`` op by op or captured): the EM's host
    reads in the loop, in full trips and in its finalize; its trips, full
    and plain; the calls on each path; the captured stretches run, by name
    (``_Driver.run``), and executed (``_store``: on the CPU's rehearsal
    one per run, on the card only while capturing)."""

    def __init__(self, monkeypatch):
        self.where = "loop"
        self.n = {"loop": 0, "full": 0, "finalize": 0}
        self.trips = {"full": 0, "plain": 0}
        self.paths = {"eager": 0, "graphs": 0}
        self.runs = {}
        self.stores = 0
        real = tem.host_bool
        drv = tem._Driver

        def host_bool(t):
            self.n[self.where] += 1
            return real(t)

        monkeypatch.setattr(tem, "host_bool", host_bool)
        monkeypatch.setattr(tcluster, "host_bool", host_bool)
        run, store = drv.run, tem._store
        setup, trip, finalize = drv.setup, drv.trip, drv.finalize

        def counted_setup(em, inputs):
            self.paths["eager" if em.replays is None else "graphs"] += 1
            return setup(em, inputs)

        def counted_trip(em, full):
            self.trips["full" if full else "plain"] += 1
            return self._at("full" if full else "loop", trip, em, full)

        def counted_run(em, name):
            if em.replays is not None:
                self.runs[name] = self.runs.get(name, 0) + 1
            return run(em, name)

        def counted_store(*a):
            self.stores += 1
            return store(*a)

        monkeypatch.setattr(drv, "setup", counted_setup)
        monkeypatch.setattr(drv, "trip", counted_trip)
        monkeypatch.setattr(drv, "finalize",
                            lambda em: self._at("finalize", finalize, em))
        monkeypatch.setattr(drv, "run", counted_run)
        monkeypatch.setattr(tem, "_store", counted_store)

    def _at(self, where, fn, *a):
        self.where = where
        try:
            return fn(*a)
        finally:
            self.where = "loop"


def traced_em(args, cfg, monkeypatch):
    reads = Reads(monkeypatch)
    with profiling.trace() as rec:
        res = tem.expectation_maximisation(*args, cfg)
    return res, rec, reads


def check_counts(rec, reads, graphed: bool, loop: str = "uniform"):
    """Every trip a ``vp.em.iteration`` span. On the graph path
    ``em.graph_trips`` = the plain trips and ``em.graph_segments`` = the
    other stretches run, none op by op; op by op ``em.eager_segments`` and
    no replay. ``em.host_reads`` = one ``done`` read per trip (per full
    trip in the phase loop) and the loop's last, plus the full trips' and
    the finalize's own reads."""
    c = rec.counters
    trips = sum(reads.trips.values())
    rounds = reads.trips["full"] if loop == "phase" else trips
    if graphed:
        plain = reads.runs.get("plain", 0)
        assert reads.paths == {"eager": 0, "graphs": 1}
        assert c.get("em.graph_trips", 0) == plain == reads.trips["plain"]
        assert c["em.graph_segments"] == sum(reads.runs.values()) - plain
        assert "em.eager_segments" not in c
    else:
        assert reads.paths == {"eager": 1, "graphs": 0} and not reads.runs
        assert "em.graph_trips" not in c and "em.graph_segments" not in c
        assert c["em.eager_segments"] > 0
    assert reads.n["loop"] == rounds + 1
    assert c["em.host_reads"] == sum(reads.n.values())
    return trips


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graph path on the CPU: the captured step is called as it is."""
    monkeypatch.setattr(tem, "GRAPH_DEVICES", ("cpu",))
    monkeypatch.setattr(tem, "_capture", lambda step, device, shared: step)
    monkeypatch.setattr(tem, "_local", tem.threading.local())
    return tem._graphs


def test_graph_path_rehearsed_on_the_cpu(scenes, cpu_graphs, monkeypatch):
    """The graph path's buffers, copies and counters, on the CPU: the
    result of the oracle, bit for bit; one set of graphs per shape,
    refilled by each call; every stretch a replay (the phase loop's, at
    split_merge_freq 3, below); past the cap, every stretch op by op."""
    cfg = tem.EMConfig()
    want = oracle(scenes, cfg)
    res, rec, reads = traced_em(scenes, cfg, monkeypatch)
    assert_same(res, want)
    check_counts(rec, reads, graphed=True)
    assert len(cpu_graphs()) == 1 and reads.trips["full"] > 0
    # another call of the same shapes: the same graph, the new inputs
    other = bench_scenes(6, seed=5)
    assert_same(tem.expectation_maximisation(*other, cfg),
                oracle(other, cfg))
    assert len(cpu_graphs()) == 1
    # the first result does not share the graph's buffers
    assert_same(res, want)
    # another N: a second set; past the cap, every stretch op by op
    wider = bench_scenes(6, n_pad=192)
    assert_same(tem.expectation_maximisation(*wider, cfg),
                oracle(wider, cfg))
    assert len(cpu_graphs()) == 2
    monkeypatch.setattr(tem, "GRAPH_CAP", 2)
    small = bench_scenes(4, n_pad=128)
    res, rec, reads = traced_em(small, cfg, monkeypatch)
    assert len(cpu_graphs()) == 2
    check_counts(rec, reads, graphed=False)
    assert_same(res, oracle(small, cfg))


def test_phase_loop_replays_its_plain_bodies(scenes, cpu_graphs,
                                             monkeypatch):
    cfg = tem.EMConfig(split_merge_freq=3, loop="phase")
    want = oracle(scenes, dataclasses.replace(cfg, loop="uniform"))
    res, rec, reads = traced_em(scenes, cfg, monkeypatch)
    assert_same(res, want)
    assert rec.counters["em.graph_trips"] == 2 * reads.trips["full"]
    check_counts(rec, reads, graphed=True, loop="phase")


# the configurations each stretch is rehearsed in: both loops, and split,
# merge and the line weights each left out
REHEARSED = {"uniform": {}, "phase": dict(loop="phase"),
             "no_split": dict(do_split=False),
             "no_merge": dict(do_merge=False),
             "no_weights": dict(use_weights=False)}


def k3_counted(monkeypatch):
    """The twin counted as the card counts K3 (``em.cluster_launches``,
    one a call), so the CPU shows where the count is made."""
    real = tcluster.agglomerative_two

    def counted(dist, active):
        profiling.count("em.cluster_launches")
        return real(dist, active)

    monkeypatch.setattr(tcluster, "agglomerative_two", counted)


def op_by_op(args, cfg):
    """The EM's result and trace, every stretch op by op."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tem, "GRAPH_DEVICES", ())
        res, rec, reads = traced_em(args, cfg, m)
    check_counts(rec, reads, graphed=False, loop=cfg.loop)
    return res, rec


@pytest.mark.parametrize("change", REHEARSED)
@pytest.mark.parametrize("name", ["scenes", "populations"])
def test_every_stretch_rehearsed_on_the_cpu(name, change, scenes,
                                            cpu_graphs, monkeypatch):
    """Every stretch on the graph path, the capture a plain call, against
    every stretch op by op: the whole result bit for bit, the same host
    reads, one ``em.graph_segments`` per stretch run (as many as op by op
    counts ``em.eager_segments``), none op by op, and K3's count
    (``em.cluster_launches``) once per split replayed, as op by op. The 21
    populations in batches of at most 6."""
    cfg = tem.EMConfig(**REHEARSED[change])
    k3_counted(monkeypatch)
    batches = [scenes] if name == "scenes" else [
        populations(slice(r, r + 6)) for r in range(0, 21, 6)]
    for args in batches:
        want, want_rec = op_by_op(args, cfg)
        with monkeypatch.context() as m:
            got, rec, reads = traced_em(args, cfg, m)
        assert_same(got, want)
        check_counts(rec, reads, graphed=True, loop=cfg.loop)
        c, e = rec.counters, want_rec.counters
        assert c["em.host_reads"] == e["em.host_reads"]
        assert c["em.graph_segments"] == e["em.eager_segments"] == \
            reads.stores - reads.trips["plain"]
        assert c.get("em.cluster_launches", 0) == \
            e.get("em.cluster_launches", 0) == reads.runs.get("split", 0)
    assert len(cpu_graphs()) == len({a[0].shape for a in batches})


@pytest.mark.parametrize("change", REHEARSED)
def test_past_the_cap_every_stretch_runs_op_by_op(change, scenes,
                                                  cpu_graphs, monkeypatch):
    """With no room under ``GRAPH_CAP``, the graph path's inputs run op by
    op: the same result, and each stretch counted ``em.eager_segments``
    where it was counted ``em.graph_segments``."""
    cfg = tem.EMConfig(**REHEARSED[change])
    with monkeypatch.context() as m:
        want, want_rec, _ = traced_em(scenes, cfg, m)
    monkeypatch.setattr(tem, "GRAPH_CAP", 0)
    monkeypatch.setattr(tem, "_local", tem.threading.local())
    with monkeypatch.context() as m:
        got, rec, reads = traced_em(scenes, cfg, m)
    assert not cpu_graphs()
    assert_same(got, want)
    check_counts(rec, reads, graphed=False, loop=cfg.loop)
    assert rec.counters["em.eager_segments"] == \
        want_rec.counters["em.graph_segments"]
    assert rec.counters["em.host_reads"] == want_rec.counters["em.host_reads"]


# ---- the card


@pytest.fixture
def cuda(monkeypatch):
    """The card, with a graph cache of the test's own: graphs that other
    tests in the process captured would fill ``GRAPH_CAP``, and the
    stretches would run op by op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(tem, "_local", tem.threading.local())
    return torch.device("cuda")


def eager(monkeypatch):
    """Every stretch op by op on the card (no graph)."""
    monkeypatch.setattr(tem, "_graphs_of", lambda inputs, cfg: None)


def graphed(fn, monkeypatch):
    """``fn()``, checked to run every EM call on the graph path and every
    plain trip as a replay."""
    with monkeypatch.context() as m:
        reads = Reads(m)
        out = fn()
    assert reads.paths["eager"] == 0 and reads.paths["graphs"] > 0
    assert reads.runs.get("plain", 0) == reads.trips["plain"] > 0
    return out


def _em_and_horizon(args, cfg):
    res = tem.expectation_maximisation(*args, cfg)
    return res, calculate_horizon_and_ortho_vp(res.vp, res.counts,
                                               res.alive)


@pytest.mark.gpu
@pytest.mark.parametrize("loop", ["uniform", "phase"])
@pytest.mark.parametrize("batch", [32, 64])
def test_graph_equals_the_eager_body_on_the_card(cuda, batch, loop,
                                                 monkeypatch):
    """Bench scenes at the main path's chunk of 32 (at 64, two chunks
    replay one set of graphs with fresh inputs): the EM's whole result and
    both horizon points bit for bit with every stretch replayed and with
    every stretch op by op."""
    from vanishing_points_2017_tpu_torch.batching import in_chunks

    args = bench_scenes(batch, n_pad=512, sphere_size=500, device=cuda)
    cfg = tem.EMConfig(loop=loop)
    got = graphed(lambda: in_chunks(lambda *a: _em_and_horizon(a, cfg),
                                    args), monkeypatch)
    assert len(tem._graphs()) == 1
    with monkeypatch.context() as m:
        eager(m)
        want = in_chunks(lambda *a: _em_and_horizon(a, cfg), args)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    # a second call, other inputs of the same shapes
    other = bench_scenes(batch, n_pad=512, seed=9, sphere_size=500,
                         device=cuda)
    got = graphed(lambda: in_chunks(lambda *a: _em_and_horizon(a, cfg),
                                    other), monkeypatch)
    assert len(tem._graphs()) == 1
    with monkeypatch.context() as m:
        eager(m)
        want = in_chunks(lambda *a: _em_and_horizon(a, cfg), other)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("change", REHEARSED)
def test_graph_on_the_trajectory_populations(cuda, change, monkeypatch):
    from vanishing_points_2017_tpu_torch.batching import in_chunks

    args = [a.to(cuda) for a in populations()]
    for num_iter in (1, 2, 3, 100):
        cfg = tem.EMConfig(num_iter=num_iter, **REHEARSED[change])
        got = graphed(lambda: in_chunks(lambda *a: _em_and_horizon(a, cfg),
                                        args), monkeypatch)
        with monkeypatch.context() as m:
            eager(m)
            want = in_chunks(lambda *a: _em_and_horizon(a, cfg), args)
        assert_same(got[0], want[0])
        assert_same(got[1], want[1])


@pytest.mark.gpu
def test_another_shape_captures_another_graph(cuda, monkeypatch):
    cfg = tem.EMConfig()
    for n_pad, keys in ((512, 1), (256, 2), (512, 2)):
        args = bench_scenes(32, n_pad=n_pad, device=cuda)
        graphed(lambda: tem.expectation_maximisation(*args, cfg),
                monkeypatch)
        assert len(tem._graphs()) == keys


@pytest.mark.gpu
def test_counters_on_the_card(cuda, monkeypatch):
    """``em.graph_trips`` = the plain trips, ``em.graph_segments`` = the
    other stretches replayed, ``em.host_reads`` = the trips' ``done``
    reads plus the full trips' and the finalize's, as op by op; K3's
    launches (``em.cluster_launches`` and the kernel's own count) one per
    split replayed and per ``cluster_two`` kernel in a device trace, as
    op by op; the capture's own run of K3 counted nowhere."""
    import sys

    sys.path.insert(0, ROOT)
    from chip_smoke import device_kernels

    args = bench_scenes(32, n_pad=512, sphere_size=500, device=cuda)
    cfg = tem.EMConfig()
    k3 = tcluster.CLUSTER_KERNEL
    before = k3.launches
    with monkeypatch.context() as m:
        reads = Reads(m)
        tem.expectation_maximisation(*args, cfg)  # captured untraced
    assert k3.launches - before == reads.runs.get("split", 0) > 0
    before = k3.launches
    with monkeypatch.context() as m:
        reads = Reads(m)
        with device_kernels(r"\bcluster_two\(") as traced:
            tem.expectation_maximisation(*args, cfg)
    assert k3.launches - before == traced["n"] == reads.runs["split"]
    before = k3.launches
    res, rec, reads = traced_em(args, cfg, monkeypatch)
    launched = k3.launches - before
    check_counts(rec, reads, graphed=True)
    c = rec.counters
    assert c["em.graph_trips"] > reads.trips["full"] > 0
    assert c.get("em.cluster_launches", 0) == launched == \
        reads.runs.get("split", 0)
    with monkeypatch.context() as m:
        eager(m)
        before = k3.launches
        want, want_rec, _ = traced_em(args, cfg, m)
    assert_same(res, want)
    e = want_rec.counters
    assert c["em.host_reads"] == e["em.host_reads"]
    assert c["em.graph_segments"] == e["em.eager_segments"]
    assert e.get("em.cluster_launches", 0) == k3.launches - before == \
        launched
