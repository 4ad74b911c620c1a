"""The port's tracing: spans and counters inside its layers, recorded on
the device trace's clock, and logging.

* :func:`span`: a named host span around one layer's call. Off (the
  default) it costs one read of a module global and returns one shared
  no-op context; inside a :func:`trace` session it is a
  ``torch.profiler.record_function`` range, which lands on kineto's
  timeline beside the device's kernels, copies and sets.
* :func:`batch`: the root span ``vp.batch`` of one entry call, which
  opens the per-request counters; inside another batch it is the no-op.
* :func:`count`: adds to a counter of the open batch; off, nothing.
* :func:`tally`: makes a count kept outside the session (a hand-written
  kernel's launches) through the same hold as :func:`count`.
* :func:`held`: keeps the counts of a block (a CUDA graph's capture) for
  the caller to make at each replay.
* :func:`trace`: a kineto session that records the device's activity and,
  on the host, only the ``record_function`` ranges (the user scope:
  never every ATen op), so the loop runs near its untraced pace. It
  yields a :class:`Record`, filled when the block ends, and writes
  ``trace.json``, a Chrome trace, into ``log_dir`` when one is given.
* :func:`get_logger`: stdlib logging in one format.

The spans and the counters, and what reads them
(``vpbench/metrics/``):

| name | where | read as |
|---|---|---|
| ``vp.batch`` | ``pipeline.device_pipeline_full`` / ``device_pipeline_batch`` | the batch each span, launch and idle interval belongs to |
| ``vp.detector`` | ``ops.lines_device.detect_segments_device`` | ``detector_span_ms``, ``detector_idle_ms`` |
| ``vp.detector.ccl`` | ``ops.lines_device.connected_components`` (K1) | K1's share of the detector, in the Chrome trace |
| ``vp.render`` | ``ops.sphere.sphere_image_uint8`` | ``render_span_ms`` |
| ``vp.cnn`` | ``models.cnn.VPNet.forward`` | ``cnn_span_ms`` |
| ``vp.em`` | ``em.em.expectation_maximisation``, per chunk | ``em_span_ms``, ``em_idle_ms``, ``em_launches`` |
| ``vp.em.setup`` | the EM's set-up (``em.em._Driver.setup``), inside ``vp.em`` | none yet |
| ``vp.em.iteration`` | each EM trip (``em.em._Driver.trip``): an ``em.em._iteration`` call op by op, or a trip's graph replays and host reads | ``em_trips`` |
| ``vp.em.finalize`` | the EM's convergence block (``em.em._Driver.finalize``), inside ``vp.em`` | none yet |
| ``vp.horizon`` | ``em.horizon.calculate_horizon_and_ortho_vp``, per chunk | ``horizon_span_ms`` |
| counter ``em.host_reads`` | ``em.reads.host_bool``: every device-to-host read of the EM | ``em_host_reads`` |
| counter ``em.graph_trips`` | ``em.em._Driver.run``: the EM's plain trips run as one CUDA graph replay | none yet |
| counter ``em.graph_segments`` | ``em.em._Driver.run``: the EM's other stretches between two host reads, each one CUDA graph replay | none yet |
| counter ``em.eager_segments`` | ``em.em._Driver.run``: those stretches run op by op (on the CPU, past ``GRAPH_CAP``) | none yet |
| counter ``em.cluster_launches`` | ``em.cluster.agglomerative_two``: K3's launches, made again at each replay of a graph that holds one | none yet |
| ``vp.batch`` | ``models.train.device_step`` | the training step each span, launch and idle interval belongs to |
| ``vp.train.input`` | ``models.train.device_step``: the copy in, K2, floor and mean, the dropout masks | ``train_input_span_ms`` |
| ``vp.train.forward`` | ``models.train.train_step``: ``VPNet.logits`` and the loss | ``train_forward_span_ms`` |
| ``vp.train.backward`` | ``models.train.train_step``: ``torch.autograd.grad`` (and the dp all-reduce on a mesh) | ``train_backward_span_ms`` |
| ``vp.train.update`` | ``models.train.train_step``: ``sgd_update`` | ``train_update_span_ms``, ``train_update_roofline`` |

The training step's device idle, over all of its layers and ``outside``,
is ``train_idle_ms``.

Device idle outside every layer span (the copy in, the readback, the
caller's loop) is ``outside_idle_ms``. A span never synchronizes and
never reads from the device, so outputs are the same with tracing on.
The spans are reached from deep inside the layers, so the session is
module state, one per process; its batches and counters assume the
traced calls run on one thread.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import logging
import os

import torch

# the layers: serving's five and the training step's four; a span's layer
# is the longest of them that its name is or starts with (and a ".")
LAYERS = ("vp.detector", "vp.render", "vp.cnn", "vp.em", "vp.horizon",
          "vp.train.input", "vp.train.forward", "vp.train.backward",
          "vp.train.update")
OUTSIDE = "outside"
BATCH = "vp.batch"
SESSION = "vp.session"  # bounds the session's stretch on kineto's clock
DEVICE_OPS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CALLS = {"cuda_runtime", "cuda_driver"}

_NOOP = contextlib.nullcontext()
_session: "_Session | None" = None  # set while a trace session runs
_held: "list | None" = None  # set inside held()


def get_logger(name: str = "vp_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class _Session:
    """The counters of a running session: one dict per ``vp.batch`` in
    the order the batches ran, and ``loose`` for counts outside any."""

    def __init__(self):
        self.batches: list[dict] = []
        self.loose: dict = {}
        self.current: dict = self.loose


def span(name: str):
    """A context manager around one layer's work, recorded as ``name``
    inside a :func:`trace` session; the shared no-op otherwise."""
    if _session is None:
        return _NOOP
    return torch.profiler.record_function(name)


def batch():
    """The root span ``vp.batch`` of one entry call, with counters of its
    own; the no-op outside a session or inside another batch."""
    if _session is None or _session.current is not _session.loose:
        return _NOOP
    return _batch_span(_session)


@contextlib.contextmanager
def _batch_span(s: _Session):
    s.current = {}
    s.batches.append(s.current)
    try:
        with torch.profiler.record_function(BATCH):
            yield
    finally:
        s.current = s.loose


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open batch (of the session
    where no batch is open); nothing outside a session. Inside
    :func:`held`, kept for the caller to make instead."""
    if _held is not None:
        _held.append(functools.partial(count, name, n))
    elif _session is not None:
        c = _session.current
        c[name] = c.get(name, 0) + n


def tally(again) -> None:
    """Make a count kept outside the session now, by calling ``again``
    (a hand-written kernel's count of its launches); inside :func:`held`,
    keep it for the caller to make instead."""
    if _held is not None:
        _held.append(again)
    else:
        again()


@contextlib.contextmanager
def held():
    """The counts made inside the block (:func:`count`, :func:`tally`),
    kept in the yielded list, each a call that makes it, and made nowhere
    else: for work recorded now and run later (a CUDA graph's capture),
    whose counts the caller makes again at each run."""
    global _held
    outer, _held = _held, []
    try:
        yield _held
    finally:
        _held = outer


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record the block's spans, counters and device activity; yields a
    :class:`Record`, filled when the block ends. The session's end waits
    for the CUDA device, so every launch inside it is recorded. With a
    ``log_dir``, ``trace.json`` (Chrome trace) is written there."""
    global _session
    if _session is not None:
        raise RuntimeError("a trace session is already running")
    from torch._C._profiler import RecordScope, _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    cuda = torch.cuda.is_available()
    acts = {ProfilerActivity.CPU}
    if cuda:
        acts.add(ProfilerActivity.CUDA)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    record = Record()
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    _session = session = _Session()
    try:
        with torch.profiler.record_function(SESSION):
            yield record
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        _session = None
        result = _disable_profiler()
    record.read(events_of(result.events()), session)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        result.save(os.path.join(log_dir, "trace.json"))


def _kind(e, cpu) -> str | None:
    """``span``, ``launch``, ``device``, ``other`` or None (nothing to
    keep: the spans kineto projects onto the device) for one kineto
    event. Where the event does not name its activity (torch 2.11), a
    CUDA call is known by its name."""
    act = e.activity_type() if hasattr(e, "activity_type") else None
    user = e.is_user_annotation() or act in ("user_annotation",
                                             "gpu_user_annotation")
    if e.device_type() == cpu:
        if user:
            return "span"
        if act in LAUNCH_CALLS or (act is None and e.name().startswith("cu")):
            return "launch"
        return "other"
    return "device" if not user and (act is None or act in DEVICE_OPS) \
        else None


def events_of(kineto_events) -> list:
    """Kineto events -> (kind, name, start ns, end ns, correlation id)
    tuples; kind is ``span`` (a ``record_function`` range on the host),
    ``launch`` (a CUDA runtime or driver call: its correlation id is that
    of the kernel, copy or set it launched), ``device`` (a kernel, copy or
    set) or ``other`` (any other event on the host)."""
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in kineto_events:
        kind = _kind(e, cpu)
        if kind is not None:
            s = e.start_ns()
            out.append((kind, e.name(), s, s + e.duration_ns(),
                        e.correlation_id()))
    return out


def _layer(name: str) -> str:
    inside = [lay for lay in LAYERS
              if name == lay or name.startswith(lay + ".")]
    return max(inside, key=len) if inside else OUTSIDE


def _innermost(spans: list) -> tuple[list, list, list]:
    """Spans (name, start, end), nested as one thread's are -> disjoint
    segments (starts, ends, names): at each moment the innermost span
    open then."""
    bounds = sorted([(s, 1, -(e - s), n) for n, s, e in spans]
                    + [(e, 0, 0, n) for n, s, e in spans])
    starts, ends, names = [], [], []
    stack: list = []
    t_prev = None
    for t, opening, _, n in bounds:
        if stack and t > t_prev:
            starts.append(t_prev)
            ends.append(t)
            names.append(stack[-1])
        if opening:
            stack.append(n)
        elif n in stack:
            del stack[len(stack) - 1 - stack[::-1].index(n)]
        t_prev = t
    return starts, ends, names


def _at(seg: tuple, t: int):
    """The name of the segment of ``seg`` holding ``t``, or None."""
    starts, ends, names = seg
    i = bisect.bisect_right(starts, t) - 1
    return names[i] if i >= 0 and t < ends[i] else None


def _union(iv: list) -> list:
    out: list = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlaps(iv: list, seg: tuple):
    """Yield (name, ns) of every overlap between the intervals ``iv`` and
    the disjoint segments ``seg``, both sorted by start."""
    starts, ends, names = seg
    j = 0
    for s, e in iv:
        while j < len(starts) and ends[j] <= s:
            j += 1
        k = j
        while k < len(starts) and starts[k] < e:
            yield names[k], min(e, ends[k]) - max(s, starts[k])
            k += 1


class Record:
    """What a :func:`trace` session saw, per ``vp.batch`` in the order the
    batches ran (``batches``), each a dict of

    * ``span_ms``: host ms in each span name (the spans of a name summed);
    * ``spans``: how many spans of each name;
    * ``busy_ms``, ``launches``: per layer (``LAYERS`` and ``outside``),
      the device ms and the count of the kernels, copies and sets
      launched while the host was in it (each charged to the innermost
      span open at its launch);
    * ``idle_ms``: per layer and ``outside``, the ms the device was idle
      while the host was in it, each idle interval split exactly by the
      spans it overlaps;
    * ``counters``: the batch's counters.

    Batch k's stretch runs from the end of batch k - 1 (the session's
    start for the first) to its own end (the session's end for the last),
    so the copy in and the readback fall in a batch, and the batches'
    idle sums to the session's. ``window_ms``, ``busy_ms`` and ``idle_ms``
    are the session's totals, ``device_ops`` its count of kernels, copies
    and sets, ``counters`` its counters summed with those outside any
    batch, ``unlaunched`` the device ops whose launch call was not
    recorded (charged to ``outside`` in the batch whose stretch holds
    their start), ``host`` every event recorded on the host but the CUDA
    calls, as (name, start ns, end ns), and ``bounds`` the session's
    (start, end) on the same clock."""

    def __init__(self):
        self.batches: list = []
        self.counters: dict = {}
        self.host: list = []
        self.bounds = (0, 0)
        self.window_ms = self.busy_ms = self.idle_ms = 0.0
        self.device_ops = self.unlaunched = 0

    def read(self, events: list, session: _Session | None = None) -> None:
        """Fill the record from :func:`events_of`'s tuples and the
        session's counters."""
        host = [(n, s, e) for k, n, s, e, _ in events
                if k in ("span", "other")]
        win = [(s, e) for k, n, s, e, _ in events
               if k == "span" and n == SESSION]
        spans = [(n, s, e) for k, n, s, e, _ in events
                 if k == "span" and n != SESSION]
        dev = [(s, e, c) for k, _, s, e, c in events if k == "device"]
        if win:
            t0, t1 = win[0]
        else:
            t0 = min([s for _, s, _ in host] + [s for s, _, _ in dev] or [0])
            t1 = max([e for _, _, e in host] + [e for _, e, _ in dev] or [0])
        self.host, self.bounds = host, (t0, t1)

        # each device op's layer and batch: the innermost span open at the
        # host time of its launch call
        launch = {c: s for k, _, s, _, c in events if k == "launch"}
        seg = _innermost(spans)
        ends = sorted(e for n, _, e in spans if n == BATCH)
        nb = max(len(ends), 1)
        rows = [{"span_ms": {}, "spans": {}, "busy_ms": {}, "launches": {},
                 "idle_ms": {}, "counters": {}} for _ in range(nb)]

        def slot(t):  # the batch whose stretch holds host time t
            return min(bisect.bisect_left(ends, t), nb - 1)

        for s, e, c in dev:
            t = launch.get(c)
            name = _at(seg, t) if t is not None else None
            lay = _layer(name) if name else OUTSIDE
            r = rows[slot(s if t is None else t)]
            r["busy_ms"][lay] = r["busy_ms"].get(lay, 0.0) + (e - s) / 1e6
            r["launches"][lay] = r["launches"].get(lay, 0) + 1

        for n, s, e in spans:
            r = rows[slot(e)]
            r["span_ms"][n] = r["span_ms"].get(n, 0.0) + (e - s) / 1e6
            r["spans"][n] = r["spans"].get(n, 0) + 1

        # the device's idle intervals within the session, split by batch
        # stretch and by the innermost layer span the host was in
        busy = _union([(max(s, t0), min(e, t1)) for s, e, _ in dev
                       if e > t0 and s < t1])
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        cuts = [t0] + ends[:-1] + [t1] if ends else [t0, t1]
        lseg = _innermost([(_layer(n), s, e) for n, s, e in spans
                           if _layer(n) != OUTSIDE])
        for k in range(nb):
            a, b = cuts[k], cuts[k + 1]
            part = [(max(s, a), min(e, b)) for s, e in idle
                    if e > a and s < b]
            total = sum(e - s for s, e in part)
            r = rows[k]["idle_ms"]
            for lay, ns in _overlaps(part, lseg):
                r[lay] = r.get(lay, 0.0) + ns / 1e6
                total -= ns
            r[OUTSIDE] = r.get(OUTSIDE, 0.0) + total / 1e6

        counted = session.batches if session is not None else []
        for r, c in zip(rows, counted):
            r["counters"] = dict(c)
        totals: dict = dict(session.loose) if session is not None else {}
        for c in counted:
            for n, v in c.items():
                totals[n] = totals.get(n, 0) + v
        self.counters = totals
        self.batches = rows if ends else []
        self.device_ops = len(dev)
        self.unlaunched = sum(c not in launch for _, _, c in dev)
        self.window_ms = (t1 - t0) / 1e6
        self.busy_ms = sum(e - s for s, e in busy) / 1e6
        self.idle_ms = sum(e - s for s, e in idle) / 1e6
