"""The training job: Caffe's SGD step of the VP-grid CNN through the
port's device step, one step in flight.

Set-up loads or builds K2, reads the configuration's weights (fc6 and fc7
multiplied out dense, ``vpbench/weights.py``) into the port's training
state (``models/train.init_state``: float32 parameters, zero momentum,
bfloat16 products) at the configuration's base_lr, and draws the cell's
pool of training batches from the seed into pinned host memory
(``vpbench/train_scenes.py``): host synthesis is set-up, as the paper's
Caffe job read pre-made examples. The window cycles through the pool in
an order drawn from the seed (``run.window_order``); step ``i`` is the
port's ``models/train.device_step`` on pool batch ``order[i]`` (the copy
in, K2, floor and mean, the dropout masks from
``step_generator(seed, step)``, forward, backward and update), and the
host read of its loss stops its clock. A step completes the traffic's
``batch`` training images. The warm-up runs :data:`WARM_STEPS` steps on
the order's last batches; the state trains on through the window.

Judged: the traffic's ``judged`` steps among the window's first 64. A
judged step keeps its pool batch, its dropout masks, its loss, the
network's input it rendered and the parameters and momentum after it;
the step before it keeps the parameters and momentum after itself, the
state the judged step started from (the warm-up keeps them where step 0
is judged). Each state is copied on the card, outside the step's clock
(about 2 GB at the published widths). After ``free()`` the plain
reference (``vpbench/reference/train.py``) judges each from that state,
batch and masks:

* ``image_off``: the largest share, per image, of input pixels more than
  ``grey_tol`` grey levels from the reference's render, floor and mean;
* ``loss_off``: the largest relative difference of the loss, the
  reference's forward run on the program's input;
* ``step_off``: the largest, over the parameter tensors and the judged
  steps, relative L2 difference between the program's step term,
  momentum * V_before - V_after, and the reference's
  local_lr * (grad + local_wd * theta);
* ``theta_off``: the largest, over the parameter tensors and the judged
  steps, relative L2 distance of the reference's new momentum,
  momentum * V_before - local_lr * (grad + local_wd * theta), from the
  increments that give the program's theta_after when added to
  theta_before in float32 (per element, the interval between the
  rounding boundaries around theta_after): what Caffe adds to the
  parameters. An increment under half a float32 step of theta is lost in
  the addition, for the program and the reference alike; this measure
  reads no error for it, and 1 where the parameters do not move at all.

Traced extras: one more pass over the stretch's steps inside the port's
trace session (``utils/profiling.trace``), whose record gives per step
the four training spans, the update's device time and the step's device
idle; the readers take medians (``vpbench/metrics/train_*.py``).
"""

from __future__ import annotations

import math
import statistics

import torch

from vpbench import train_scenes, weights
from vpbench.run import log, window_order

WARM_STEPS = 3
SPANS = {"input": "vp.train.input", "forward": "vp.train.forward",
         "backward": "vp.train.backward", "update": "vp.train.update"}


def check_solver(config: dict) -> None:
    """Raise where the configuration states a solver, dropout or
    precision that the port's training step does not run."""
    from vanishing_points_2017_tpu_torch.models import train

    s = config["solver"]
    port = {"type": "SGD", "lr_policy": "step", "gamma": train.LR_GAMMA,
            "momentum": train.MOMENTUM, "weight_decay": train.WEIGHT_DECAY,
            "lr_mult": [1, 2], "decay_mult": [1, 0]}
    bad = sorted(k for k, v in port.items() if s[k] != v)
    if config["dropout"]["ratio"] != 1.0 - train.KEEP_PROB:
        bad.append("dropout")
    if config["precision"]["products"] != "bfloat16":
        bad.append("precision")
    if bad:
        raise ValueError(f"the port's training step does not run {bad}")


def _clone(d: dict) -> dict:
    return {n: {k: v.detach().clone() for k, v in x.items()}
            for n, x in d.items()}


def spans_summary(rec) -> dict | None:
    """A ``profiling.Record`` of training steps -> {number: median over
    its steps}: ``<short>_span_ms`` for each of :data:`SPANS`,
    ``update_busy_ms`` (device ms of the ops launched in
    ``vp.train.update``), ``idle_ms`` (device idle in the step's stretch,
    every layer and ``outside``), ``launches`` (every device op of the
    step), and ``steps``; None without a step."""
    rows = []
    for b in rec.batches:
        r = {f"{k}_span_ms": b["span_ms"].get(n, 0.0)
             for k, n in SPANS.items()}
        r.update(update_busy_ms=b["busy_ms"].get(SPANS["update"], 0.0),
                 idle_ms=sum(b["idle_ms"].values()),
                 launches=sum(b["launches"].values()),
                 spans=sum(b["spans"].get(n, 0) for n in SPANS.values()))
        rows.append(r)
    if not rows:
        return None
    out = {k: float(statistics.median(r[k] for r in rows)) for k in rows[0]}
    out["steps"] = len(rows)
    return out


class Traced:
    """The training job's extras for the metric readers: ``spans``, the
    medians of :func:`spans_summary` (None where the program records no
    training spans)."""

    def __init__(self, spans: dict | None):
        self.spans = spans

    def train_span(self, name: str):
        return None if self.spans is None else self.spans.get(name)


class Train:
    """The port's training state, the pool and the window's order for one
    seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, dev, root: str,
                 mark):
        from vanishing_points_2017_tpu_torch.models import train
        from vanishing_points_2017_tpu_torch.ops.sphere import SPHERE_KERNEL

        self._device_step = train.device_step
        mark("import")
        if dev.type == "cuda":
            SPHERE_KERNEL.build()
            torch.cuda.set_device(dev)
        mark("kernels")
        check_solver(config)
        self.config, self.traffic, self.dev = config, traffic, dev
        self.solver = config["solver"]
        self.size = config["network"]["input"]
        params, self.mean = weights.load(config, root, dev)
        self.state = train.init_state(params, 0,
                                      base_lr=self.solver["base_lr"],
                                      lr_stepsize=self.solver["stepsize"])
        del params
        self.mask_seed = seed % 2 ** 32
        mark("weights")
        self.pool = train_scenes.draw_pool(traffic, seed,
                                           pin=dev.type == "cuda")
        mark("pool")
        self.items = traffic["batch"]
        self.order, self.steps_judged = window_order(traffic, seed)
        self.judged = sorted(set(self.steps_judged)
                             | {j - 1 for j in self.steps_judged if j > 0})
        self.before0 = None

    def _index(self, i: int) -> int:
        return self.order[i % len(self.order)]

    def _run(self, k: int):
        lines, lmask, labels = self.pool.batch(k)
        return self._device_step(self.state, lines, lmask, labels, self.mean,
                                 self.mask_seed, self.size)

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def warm_up(self) -> None:
        for k in self.order[-WARM_STEPS:]:
            self._run(k).loss.item()
        if self.dev.type == "cuda":
            log(f"training step's own peak in the warm-up: "
                f"{torch.cuda.max_memory_allocated(self.dev)} B")
        if 0 in self.steps_judged:
            self.before0 = {"theta_next": _clone(self.state.model.params()),
                            "v_next": _clone(self.state.momentum)}
            self._sync()

    def step(self, i: int):
        out = self._run(self._index(i))
        out.loss.item()
        return out

    def keep(self, i: int, out) -> dict:
        """What step ``i`` keeps, as set out above, copied on the device."""
        kept: dict = {"i": i}
        if i in self.steps_judged:
            kept.update(batch=self._index(i), step=self.state.step - 1,
                        keep=out.keep, loss=float(out.loss),
                        images=out.images,
                        theta_after=_clone(self.state.model.params()),
                        v_after=_clone(self.state.momentum))
        if i + 1 in self.steps_judged:
            kept.update(theta_next=_clone(self.state.model.params()),
                        v_next=_clone(self.state.momentum))
        self._sync()
        return kept

    def traced(self, kept: list, n: int) -> Traced:
        from vanishing_points_2017_tpu_torch.utils import profiling

        if SPANS["update"] not in getattr(profiling, "LAYERS", ()):
            log("train spans: the program records no training spans")
            return Traced(None)
        with profiling.trace() as rec:
            for i in range(n):
                self.step(i)
        s = spans_summary(rec)
        if s is not None:
            log("train spans (medians per step over "
                f"{s['steps']} steps): " + ", ".join(
                    f"{k} {s[f'{k}_span_ms']:.3f} ms" for k in SPANS)
                + f"; update device busy {s['update_busy_ms']:.3f} ms, "
                f"step idle {s['idle_ms']:.3f} ms, {s['launches']:.0f} "
                f"launches; session {rec.window_ms:.3f} ms, device busy "
                f"{rec.busy_ms:.3f} ms, {rec.unlaunched} of "
                f"{rec.device_ops} device ops without a launch call")
        return Traced(s)

    def free(self) -> None:
        del self.state, self._device_step

    def judge(self, kept: list) -> dict:
        from vpbench.reference import train as ref

        grey_tol = self.traffic["judge"]["check"]["grey_tol"]
        by_i = {k["i"]: k for k in kept}
        numbers = {"image_off": 0.0, "loss_off": 0.0, "step_off": 0.0,
                   "theta_off": 0.0}
        for j in self.steps_judged:
            after = by_i[j]
            before = self.before0 if j == 0 else by_i[j - 1]
            for k, v in judge_step(ref, self, before, after,
                                   grey_tol).items():
                numbers[k] = max(numbers[k], v)
        return numbers


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 difference of ``got`` from ``want``; NaN reads inf."""
    rel = float((got - want).norm() / want.norm().clamp(min=1e-300))
    return rel if math.isfinite(rel) else math.inf


def _off_increments(theta_before: torch.Tensor, theta_after: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Per element, the signed distance of ``v`` (float64) from the
    increments that theta_before + increment rounds to theta_after in
    float32 (0 inside): the rounding boundaries lie halfway to
    theta_after's float32 neighbours."""
    a = theta_after.float()
    inf = torch.tensor(math.inf, device=a.device)
    b = theta_before.double()
    lo = (a.double() + torch.nextafter(a, -inf).double()) / 2 - b
    hi = (a.double() + torch.nextafter(a, inf).double()) / 2 - b
    return (lo - v).clamp(min=0) - (v - hi).clamp(min=0)


def judge_step(ref, work, before: dict, after: dict,
               grey_tol: float) -> dict:
    """One judged step's numbers, as set out above (NaN reads inf), the
    reference's products in bfloat16, what ``check_solver`` holds the
    configuration to."""
    dev = work.dev
    l, lm, labels = (t.to(dev) for t in work.pool.batch(after["batch"]))
    with torch.no_grad():
        x_ref = ref.input_images(l, lm, work.mean, work.size)
        off = ((after["images"] - x_ref).abs() > grey_tol).double()
        image_off = float(off.mean((1, 2, 3)).max())
    theta = before["theta_next"]
    loss, grads = ref.loss_and_grads(theta, after["images"], labels,
                                     after["keep"], "bf16")
    loss = float(loss)
    loss_off = abs(after["loss"] - loss) / max(abs(loss), 1e-30)
    terms = ref.step_terms(theta, grads, work.solver, after["step"])
    del grads
    # the momentum in the state's precision, as Caffe's float solver
    # applies it: 0.9 itself would read (0.9 - 0.9f) * V_before as error
    m = torch.tensor(work.solver["momentum"], dtype=torch.float32,
                     device=dev)
    step_off = theta_off = 0.0
    with torch.no_grad():
        for n, d in terms.items():
            for k, want in d.items():
                v_before = (m * before["v_next"][n][k]).double()
                want = want.double()
                got = v_before - after["v_after"][n][k].double()
                step_off = max(step_off, _rel(got, want))
                v_new = v_before - want
                theta_off = max(theta_off, _rel(
                    v_new + _off_increments(theta[n][k],
                                            after["theta_after"][n][k],
                                            v_new), v_new))
    out = {"image_off": image_off, "loss_off": loss_off,
           "step_off": step_off, "theta_off": theta_off}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def build(config: dict, traffic: dict, seed: int, dev, root: str,
          mark) -> Train:
    return Train(config, traffic, seed, dev, root, mark)
