"""Expectation-maximisation VP refinement (``em/em.py`` of the JAX package),
batched over images.

VPs live in ``m_slots`` fixed slots with an ``alive`` mask (delete = mask
off, split = write into the first free slot, merge = write + mask off);
lines are padded with an ``lmask``; variances are carried as ``log s``.
The JAX ``lax.while_loop`` bodies become Python loops over batched state:
every loop runs while ANY image still needs it, and an image whose own
condition is false keeps its state unchanged — what a vmapped
``while_loop`` does. The loop conditions are read on the host, each
through ``reads.host_bool``, which counts it (``em.host_reads``) in a
trace session; the call is the span ``vp.em`` and each loop body
``vp.em.iteration``.

The images advance in lockstep: each trip either ends an image (it
converged or lost its last VP) or moves it on by one iteration, so every
image still running at trip ``t`` is at iteration ``t``. Split and merge
are gated by ``i % split_merge_freq``, so they can only be due on the
trips :func:`_full_trip` picks from the host's trip count; every other
trip runs the plain body (split and merge left out), which reads nothing
back and gives the same state.

``EMConfig.loop`` picks the JAX package's loop structure. ``"uniform"``
(the default) runs one body per trip and reads ``done`` after each: the
full body on :func:`_full_trip`'s trips, where a split or merge step with
no image due is skipped outright (leaving every state unchanged, as the
gated JAX body does), the plain body on the others. ``"phase"`` runs one
full body and then ``split_merge_freq - 1`` plain bodies per trip, and
reads ``done`` once per trip. Its outputs are bit-identical to the
uniform loop's; bodies run on images already done leave them unchanged.

A call runs as a sequence of stretches (:func:`_stretches`): the device
work between two host reads (the set-up, a plain trip, a full trip's
gates, split, E/M step, merge step and swap, the convergence block's
pieces and prune step), driven by :class:`_Driver` over the call's
buffers by name. On a CUDA device each stretch is one replay of a CUDA
graph: a set of graphs is captured once per device, configuration and
input shapes over buffers of its own, a call copies its inputs in and
its result out, and the host reads the loop conditions from those
buffers, the same reads in the same places as op by op. On the CPU, and
for shapes past ``GRAPH_CAP``, every stretch runs op by op. The set-up is
the span ``vp.em.setup`` and the convergence block ``vp.em.finalize``;
replays count ``em.graph_segments`` (a plain trip's ``em.graph_trips``),
stretches op by op ``em.eager_segments`` (plain trips aside).

Reference quirks kept (see the JAX module): split's in-image check on the
raw slot index, merge writing s[k] before validating, NaN stddevs sorting
first in the split order, the hardcoded count < 3 initial prune.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import NamedTuple

import torch

from ..ops import lines as lineops
from ..ops import probability as prob
from ..utils import profiling
from . import cluster as clust
from . import init_vps
from . import weights as wmod
from .reads import host_bool

LOG_S_THRESH = prob.LOG_S_FLOOR  # log(1e-200)
SPLIT_MERGE_IT = 100  # reference hardcodes split_merge_it = 100
MERGE_MAX_STDD = 0.01  # merge_vps' own default max_stdd
# where the EM's stretches run as captured graphs, and how many sets of
# them a thread keeps; further shapes run op by op
GRAPH_DEVICES = ("cuda",)
GRAPH_CAP = 8


@dataclasses.dataclass(frozen=True)
class EMConfig:
    """EM hyperparameters (defaults = reference defaults)."""

    num_iter: int = 100
    do_merge: bool = True
    do_split: bool = True
    do_iterations: bool = True
    distance_measure: str = "angle"
    use_weights: bool = True
    wbias: float = 1.0
    num_init_vp: int = 25
    split_merge_freq: int = 10
    merge_thresh: float = 1e-3
    outlier_thresh: float = 1.96 ** 2
    final_convergence: float = 5e-3
    num_min_lines: int = 3
    m_slots: int = 40
    wrap_quirk: bool = True
    # "uniform": one gated body per trip; "phase": a full body then
    # split_merge_freq - 1 plain ones per trip (see the module docstring)
    loop: str = "uniform"

    def __post_init__(self):
        if self.distance_measure not in ("angle", "dotprod"):
            raise ValueError(
                f"distance measure {self.distance_measure!r} not supported by "
                "the EM (reference asserts at vp_localisation.py:203)")
        if self.loop not in ("uniform", "phase"):
            raise ValueError(f"loop {self.loop!r}: expected 'uniform' or "
                             "'phase'")

    @property
    def max_stdd(self) -> float:
        return 1e-6 if self.distance_measure == "angle" else 1e-3

    @property
    def s_init_factor(self) -> float:
        return self.max_stdd


class EMResult(NamedTuple):
    vp: torch.Tensor               # (B, m_slots, 3)
    alive: torch.Tensor            # (B, m_slots)
    vp_assoc: torch.Tensor         # (B, N) slot index or -1
    counts: torch.Tensor           # (B, m_slots)
    counts_weighted: torch.Tensor  # (B, m_slots)
    decision_metric: torch.Tensor  # (B, m_slots, N)
    log_sigma: torch.Tensor        # (B, m_slots)
    iterations: torch.Tensor       # (B,)
    valid: torch.Tensor            # (B,) False = the reference's empty dict


def _f32log(x: float) -> float:
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


LOG_MERGE_MAX_STDD = _f32log(MERGE_MAX_STDD)


def _sel(cond: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Per-image select: cond (B,) broadcast over the trailing dims."""
    return torch.where(cond.reshape(-1, *([1] * (new.dim() - 1))), new, old)


def _logsumexp_prod(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(sum exp(log_a) * b) over the last axis for b >= 0; b == 0 terms
    are excluded, NaN log_a with b > 0 propagates."""
    lb = torch.log(torch.where(b > 0, b, 1.0))
    t = torch.where(b > 0, log_a + lb, -math.inf)
    m = torch.max(t, dim=-1, keepdim=True).values
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    out = m_safe[..., 0] + torch.log(torch.sum(torch.exp(t - m_safe), dim=-1))
    return torch.where(torch.isnan(t).any(dim=-1), math.nan, out)


def _s_update_log(lvsq: torch.Tensor, p_vl: torch.Tensor) -> torch.Tensor:
    """log s = log(sum lvsq * p_vl) - log(sum p_vl) over the last axis;
    NaN when sum p_vl == 0 (the reference's -inf - -inf)."""
    log_lvsq = torch.where(lvsq > 0, torch.log(torch.where(lvsq > 0, lvsq,
                                                           1.0)), -math.inf)
    log_lvsq = torch.where(torch.isnan(lvsq), math.nan, log_lvsq)
    num = _logsumexp_prod(log_lvsq, p_vl)
    den_lin = torch.sum(p_vl, dim=-1)
    den = torch.where(den_lin > 0, torch.log(torch.where(den_lin > 0,
                                                         den_lin, 1.0)),
                      -math.inf)
    return num - den


def _vp_change(v_old: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    d = torch.abs(torch.sum(v_old * v_new, dim=-1))
    return torch.arccos(torch.clamp(d, max=1.0))


def _pairwise_vp_angles(v: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(B, M, M) |arccos(|cos|)|, diagonal pi, dead pairs 10."""
    m = v.shape[1]
    cos = torch.clamp(v @ v.transpose(1, 2), -1.0, 1.0)
    ang = torch.abs(torch.arccos(torch.clamp(torch.abs(cos), -1.0, 1.0)))
    ang = torch.where(torch.eye(m, dtype=torch.bool, device=v.device),
                      math.pi, ang)
    ok = alive[:, :, None] & alive[:, None, :]
    return torch.where(ok, ang, 10.0)


class _State(NamedTuple):
    """The loop state of a batch: iteration, VPs before and after the
    M-step, log variances, alive slots, and the per-image done / empty
    flags."""

    i: torch.Tensor
    v_cur: torch.Tensor
    v_next: torch.Tensor
    log_s: torch.Tensor
    alive: torch.Tensor
    done: torch.Tensor
    empty: torch.Tensor


class _Ctx(NamedTuple):
    """Per-call constants: the E-steps' inputs and the log-variance cap."""

    pdfpar: prob.PDFParams
    l: torch.Tensor
    lp: torch.Tensor
    lmask: torch.Tensor
    lweight: torch.Tensor
    lsim: torch.Tensor
    langles: torch.Tensor
    cfg: EMConfig
    log_max_stdd: float

    def estep(self, v, alive, log_s):
        p = prob.calc_probabilities(self.pdfpar, v, alive, self.l, self.lp,
                                    log_s, self.lmask,
                                    self.cfg.distance_measure,
                                    self.cfg.wrap_quirk)
        return p, wmod.weight_matrix(p.p_vl, self.lweight, self.lsim,
                                     bias=self.cfg.wbias)


def _merge_start(alive, go):
    """The images of ``go`` that :func:`_merge_step` should try: those
    with more than one alive VP."""
    return go & (torch.sum(alive, dim=1) > 1)


def _merge_step(v, log_s, alive, try_again, thresh: float, ctx: _Ctx):
    """One step of ``merge_vps``' loop for the images of ``try_again``:
    merge each one's closest alive VP pair (j < k: j deleted, k keeps the
    merged VP) if its angle is below ``thresh``; s[k] is written before
    the acceptance check (the reference's mutation-on-rejection quirk).
    -> (v, log_s, alive, try_again for the next step)."""
    b, ms, _ = v.shape
    bi = torch.arange(b, device=v.device)
    slots = torch.arange(ms, device=v.device)[None]
    ang = _pairwise_vp_angles(v, alive)
    flat = torch.argmin(ang.reshape(b, -1), dim=1)
    j, k = flat // ms, flat % ms
    mergeable = ang[bi, j, k] < thresh

    p, w = ctx.estep(v, alive, log_s)
    new_vp, vp_ok = wmod.calc_new_vanishing_point(
        ctx.l, (w[bi, j] + w[bi, k])[:, None])
    new_vp, vp_ok = new_vp[:, 0], vp_ok[:, 0]
    pair_pvl = p.p_vl[bi, k] + p.p_vl[bi, j]
    mean_lvsq = 0.5 * (p.lvsq[bi, :, j] + p.lvsq[bi, :, k])
    s_k = _s_update_log(mean_lvsq, pair_pvl)

    # NaN s_k accepts the merge (the reference's `s[k] > max_stdd` is
    # False for NaN); the next M-step's NaN check removes it
    accept = vp_ok & ~(s_k > LOG_MERGE_MAX_STDD)
    is_k = slots == k[:, None]
    log_s2 = torch.where(is_k, s_k[:, None], log_s)
    take = (accept & mergeable)[:, None]
    v2 = torch.where((is_k & take)[..., None], new_vp[:, None], v)
    alive2 = alive & ~((slots == j[:, None]) & take)

    upd = try_again & mergeable
    v = _sel(upd, v2, v)
    log_s = _sel(upd, log_s2, log_s)
    alive = _sel(upd, alive2, alive)
    return v, log_s, alive, upd & accept & (torch.sum(alive, dim=1) > 1)


def _split_best_vp(v_cur, log_s, alive, w, go, ctx: _Ctx):
    """Masked ``split_best_vp``: 2-cluster the lines of the worst-spread VP
    (first candidate with > 8 lines whose RAW slot is in the image) and
    replace it by the two cluster fits."""
    cfg = ctx.cfg
    b, ms, _ = v_cur.shape
    dev = v_cur.device
    bi = torch.arange(b, device=dev)
    slots = torch.arange(ms, device=dev)[None]
    lmask, langles = ctx.lmask, ctx.langles

    assoc = wmod.assoc_argmax(w, alive, lmask)
    wmax_global = torch.amax(w, dim=(1, 2))
    greedy_pos = ((assoc[:, None, :] == slots[..., None]) & (w > 0)
                  & (wmax_global > 0)[:, None, None])
    gp = greedy_pos.to(torch.float32)
    cnt = torch.sum(greedy_pos, dim=2)
    mean_phi = torch.sum(gp * langles[:, None, :], dim=2) / cnt
    var_phi = torch.sum(gp * (langles[:, None, :] - mean_phi[..., None]) ** 2,
                        dim=2) / cnt
    stdd_key = torch.where(alive, torch.sqrt(var_phi), -math.inf)
    # descending; NaN (empty assignment) first, dead slots last
    order = torch.argsort(stdd_key, dim=1, stable=True).flip(1)

    n_assigned = torch.sum((assoc[:, None, :] == order[..., None])
                           & lmask[:, None, :], dim=2)
    v2 = v_cur[..., 0:2] / v_cur[..., 2:3]  # raw slot m (quirk)
    in_img = ((v2[..., 0] > -1) & (v2[..., 0] < 1) & (v2[..., 1] > -1)
              & (v2[..., 1] < 1))
    cand = (n_assigned > 2 * 4) & in_img
    found = cand.any(dim=1)
    chosen = order[bi, torch.argmax(cand.to(torch.uint8), dim=1)]

    assigned = ((assoc == chosen[:, None]) & lmask & found[:, None]
                & go[:, None])
    ldist = 1.0 - lineops.pairwise_cosangle(ctx.lp, f=2.0)
    in_a = clust.agglomerative_two(ldist, assigned)
    in_b = assigned & ~in_a
    lsc = ctx.l * ctx.lweight[..., None]

    def fit(mask_c):
        lc = torch.where(mask_c[..., None], lsc, 0.0)
        vp = wmod.smallest_eigvec_3x3(lc.transpose(1, 2) @ lc)
        vp = torch.where(vp[..., 2:3] < 0, -vp, vp)
        return vp, torch.sum(mask_c, dim=1) >= 3

    vp_a, ok_a = fit(in_a)
    vp_b, ok_b = fit(in_b)
    cosphi = torch.clamp(torch.sum(vp_a * vp_b, dim=-1), -1.0, 1.0)
    pair_angle = torch.abs(torch.arccos(torch.clamp(torch.abs(cosphi),
                                                    -1.0, 1.0)))
    do = go & found & ok_a & ok_b & (pair_angle > cfg.merge_thresh)
    stdd_new = log_s[bi, chosen] - _f32log(2.0)

    free = torch.argmax((~alive).to(torch.uint8), dim=1)
    has_free = (~alive).any(dim=1)
    is_chosen = (slots == chosen[:, None]) & do[:, None]
    is_free = (slots == free[:, None]) & (do & has_free)[:, None]
    v_out = torch.where(is_chosen[..., None], vp_a[:, None], v_cur)
    v_out = torch.where(is_free[..., None], vp_b[:, None], v_out)
    log_s_out = torch.where(is_chosen | is_free, stdd_new[:, None], log_s)
    return v_out, log_s_out, alive | is_free


class _Final(NamedTuple):
    """The convergence block's state between its merge and its result:
    the refit VPs and log variances, the alive slots, the inlier counts
    and the decision metric of the last count pass, the images left
    without a VP by the refit, and the VPs under ``num_min_lines``
    inliers."""

    alive: torch.Tensor
    counts: torch.Tensor
    cw: torch.Tensor
    assoc3: torch.Tensor
    dm3: torch.Tensor
    v_next: torch.Tensor
    log_s: torch.Tensor
    empty2: torch.Tensor
    under: torch.Tensor


def _count_pass(v, alive, log_s, ctx: _Ctx):
    """Inlier counts of the VPs ``v``: (counts, weighted counts, line
    assignment, decision metric)."""
    _, dm = ctx.estep(v, alive, log_s)
    counts, cw, assoc = wmod.calc_vp_line_counts(
        v, alive, ctx.l, ctx.lp, ctx.lmask, log_s, dm, ctx.lweight,
        ctx.cfg.distance_measure, thresh=ctx.cfg.outlier_thresh)
    return counts, cw, assoc, dm


def _final_counts(st: _State, v_next, log_s, alive, ctx: _Ctx) -> _Final:
    """The convergence block after its merge: per-VP refit from
    argmax-assigned lines, the uniqueness filter and the first count
    pass."""
    v_cur, empty = st.v_cur, st.empty
    slots = torch.arange(v_cur.shape[1], device=v_cur.device)[None]

    p, w = ctx.estep(v_cur, alive, log_s)
    assoc = wmod.assoc_argmax(w, alive, ctx.lmask)
    assigned = assoc[:, None, :] == slots[..., None]
    has_lines = assigned.any(dim=2)
    new_vps, vp_ok = wmod.calc_new_vanishing_point(
        ctx.l, torch.where(assigned, w, 0.0))
    s_log_new = torch.clamp(_s_update_log(p.lvsq.transpose(1, 2), p.p_vl),
                            max=ctx.log_max_stdd)
    upd = alive & has_lines
    v_next = torch.where((upd & vp_ok)[..., None], new_vps, v_next)
    bad_s = torch.isnan(s_log_new) | (s_log_new < LOG_S_THRESH)
    log_s = torch.where(upd & vp_ok & ~bad_s, s_log_new, log_s)
    err = _vp_change(v_cur, v_next)
    removed = upd & (~vp_ok | bad_s | (vp_ok & ~bad_s & (err > 1.5)))
    alive = alive & ~removed

    # uniqueness filter at the OLD positions
    _, dm = ctx.estep(v_cur, alive, log_s)
    empty2 = empty | (torch.sum(alive, dim=1) == 0)
    max_dec = wmod.assoc_argmax(dm, alive, ctx.lmask)
    alive = alive & (max_dec[:, None, :] == slots[..., None]).any(dim=2)

    counts, cw, assoc3, dm3 = _count_pass(v_next, alive, log_s, ctx)
    return _Final(alive, counts, cw, assoc3, dm3, v_next, log_s, empty2,
                  alive & (counts < ctx.cfg.num_min_lines))


def _prune_step(f: _Final, ctx: _Ctx) -> _Final:
    """One step of the min-line prune: each image with a VP under
    ``num_min_lines`` inliers loses its lowest such slot, and its VPs are
    counted again."""
    slots = torch.arange(f.alive.shape[1], device=f.alive.device)[None]
    prune = f.under.any(dim=1)
    vidx = torch.argmax(f.under.to(torch.uint8), dim=1)  # lowest slot
    alive2 = f.alive & (slots != vidx[:, None])
    c2, w2, a2, d2 = _count_pass(f.v_next, alive2, f.log_s, ctx)
    alive = _sel(prune, alive2, f.alive)
    counts = _sel(prune, c2, f.counts)
    return f._replace(alive=alive, counts=counts, cw=_sel(prune, w2, f.cw),
                      assoc3=_sel(prune, a2, f.assoc3),
                      dm3=_sel(prune, d2, f.dm3),
                      under=alive & (counts < ctx.cfg.num_min_lines))


def _result(f: _Final, iterations) -> EMResult:
    valid = ~f.empty2 & (torch.sum(f.alive, dim=1) > 0)
    zero = lambda x: _sel(valid, x, torch.zeros_like(x))
    return EMResult(
        vp=torch.where((f.alive & valid[:, None])[..., None], f.v_next, 0.0),
        alive=f.alive & valid[:, None],
        vp_assoc=_sel(valid, f.assoc3, torch.full_like(f.assoc3, -1)),
        counts=zero(f.counts), counts_weighted=zero(f.cw),
        decision_metric=zero(f.dm3), log_sigma=f.log_s,
        iterations=iterations, valid=valid)


def _setup(l, lp, cnn_response, sphere_image, lmask, cfg: EMConfig):
    """The per-call constants and the loop's first state (initial VPs
    from the CNN maxima, pruned to those with >= 3 inliers) ->
    (_State, _Ctx)."""
    b, n, _ = l.shape
    ms = cfg.m_slots
    f32 = torch.float32
    dev = l.device

    l = lineops.normalize_rows(l.to(f32))
    l = torch.where(lmask[..., None], l, 0.0)
    lp = torch.where(lmask[..., None], lp.to(f32), 0.0)
    llen = lineops.line_length(lp)
    langles = lineops.lines_angles(lp)
    if cfg.use_weights:
        lsim = lineops.calc_lsim(lp, lmask, sigma=1.0)
        lscore = lineops.line_rating_knn(lp, lmask, k1=10, k2=4, sigma=1.0)
        lweight = llen * torch.clamp(lscore, 0.2, 1.0)
    else:
        lsim = torch.zeros((b, n, n), dtype=f32, device=dev)
        lweight = torch.ones((b, n), dtype=f32, device=dev)
    lweight = torch.where(lmask, lweight, 0.0)
    pdfpar = prob.pdf_params(cnn_response.to(f32))
    ctx = _Ctx(pdfpar, l, lp, lmask, lweight, lsim, langles, cfg,
               _f32log(cfg.max_stdd))

    v0, alive = init_vps.find_initial_vps(sphere_image, cnn_response.to(f32),
                                          cfg.num_init_vp, ms)
    sigma = torch.tensor(pdfpar.sigma, dtype=f32)
    log_s = torch.full((b, ms), float(torch.log(sigma * cfg.s_init_factor)),
                       dtype=f32, device=dev)

    # ---- initial prune: VPs with < 3 inliers (hardcoded 3, ref line 250)
    _, w0 = ctx.estep(v0, alive, log_s)
    counts0, _, _ = wmod.calc_vp_line_counts(
        v0, alive, l, lp, lmask, log_s, w0, lweight, cfg.distance_measure,
        thresh=cfg.outlier_thresh)
    alive = alive & (counts0 >= 3)

    flag = torch.zeros(b, dtype=torch.bool, device=dev)
    return _State(torch.zeros(b, dtype=torch.int64, device=dev), v0,
                  torch.zeros_like(v0), log_s, alive, flag, flag), ctx


def _head(st: _State, cfg: EMConfig, full: bool):
    """The body's gates: (images without a VP, images running, images at
    a split/merge iteration and images due a split; the last two None
    off a full body, the last also without ``do_split``)."""
    i = st.i
    empty_now = torch.sum(st.alive, dim=1) == 0
    go = ~st.done & ~empty_now
    phase = split_due = None
    if full:
        phase = (torch.remainder(i, cfg.split_merge_freq) == 0) & (i > 0)
        if cfg.do_split:
            # every split_merge_freq iterations, 0 < i < 100
            split_due = go & phase & (i < SPLIT_MERGE_IT)
    return empty_now, go, phase, split_due


def _step(st: _State, vc, ls, al, go, ctx: _Ctx):
    """E-step + M-step of the images ``go`` on the VPs ``vc``: weighted
    TLS refit and variance update -> (next VPs, log s, alive,
    converged)."""
    cfg, l = ctx.cfg, ctx.l
    p, w = ctx.estep(vc, al, ls)
    if cfg.do_iterations:
        new_vps, vp_ok = wmod.calc_new_vanishing_point(l, w)
        s_log_new = torch.clamp(_s_update_log(p.lvsq.transpose(1, 2),
                                              p.p_vl),
                                LOG_S_THRESH, ctx.log_max_stdd)
        s_nan = torch.isnan(s_log_new)
        v_next2 = torch.where((al & vp_ok)[..., None], new_vps, vc)
        log_s2 = torch.where(al & vp_ok, s_log_new, ls)
        err = _vp_change(vc, v_next2)
        contributes = al & vp_ok & ~s_nan
        max_err = torch.amax(torch.where(contributes, err, 0.0), dim=1)
        removed = al & (~vp_ok | s_nan | (contributes & (err > 1.5)))
        alive2 = al & ~removed
    else:
        v_next2, log_s2, alive2 = vc, ls, al
        max_err = torch.zeros(l.shape[0], dtype=torch.float32,
                              device=l.device)
    vn = _sel(go, v_next2, st.v_next)
    ls = _sel(go, log_s2, ls)
    al = _sel(go, alive2, al)
    converged = ((max_err < cfg.final_convergence)
                 | (st.i == cfg.num_iter - 1) | (not cfg.do_iterations))
    return vn, ls, al, converged


def _merge_due(i, go, converged, phase, cfg: EMConfig):
    """The images due the periodic merge: at a split/merge iteration and
    not converged in it."""
    return go & ~converged & phase & (i <= SPLIT_MERGE_IT
                                      + cfg.split_merge_freq)


def _tail(st: _State, vc, vn, ls, al, go, converged, empty_now) -> _State:
    """The buffer swap for the next iteration; images already done keep
    their whole state, as under a vmapped while_loop."""
    swap = go & ~converged
    run = ~st.done
    return _State(i=torch.where(swap, st.i + 1, st.i),
                  v_cur=_sel(run, _sel(swap, vn, vc), st.v_cur),
                  v_next=_sel(run, vn, st.v_next),
                  log_s=_sel(run, ls, st.log_s),
                  alive=_sel(run, al, st.alive),
                  done=st.done | (go & converged) | empty_now,
                  empty=st.empty | (run & empty_now))


def _full_trip(t: int, cfg: EMConfig) -> bool:
    """Whether trip ``t`` of the uniform loop runs the full body: the
    trips on which a full trip's split or merge gate can hold for an
    image at iteration ``t``, which every image still running is (module
    docstring). On the others no image is due and the plain body gives
    the same state."""
    f = cfg.split_merge_freq
    if f == 0 or t == 0 or t % f:
        return False
    return ((cfg.do_split and t < SPLIT_MERGE_IT)
            or (cfg.do_merge and t <= SPLIT_MERGE_IT + f))


# ---- the stretches: a call's device work between two host reads, each a
# function of the call's buffers by name (``ns``) -> what it writes there


_INPUTS = ("in_l", "in_lp", "in_cnn", "in_sphere", "in_lmask")
_CTX_TENSORS = ("l", "lp", "lmask", "lweight", "lsim", "langles")


def _ns_ctx(ns: dict) -> _Ctx:
    return _Ctx(prob.PDFParams(ns["means"], ns["weights"], ns["sigma"]),
                *(ns[k] for k in _CTX_TENSORS), ns["cfg"],
                ns["log_max_stdd"])


def _ns_state(ns: dict) -> _State:
    return _State(*(ns[k] for k in _State._fields))


def _ns_final(ns: dict) -> _Final:
    return _Final(*(ns["f_" + k] for k in _Final._fields))


def _with_done_all(st: _State) -> dict:
    return dict(st._asdict(), done_all=st.done.all())


def _ns_of(st: _State, ctx: _Ctx) -> dict:
    """The entries of ``ns`` that hold ``st`` and ``ctx``."""
    p = ctx.pdfpar
    return dict(cfg=ctx.cfg, means=p.means, weights=p.weights,
                sigma=p.sigma, log_max_stdd=ctx.log_max_stdd,
                **{k: getattr(ctx, k) for k in _CTX_TENSORS},
                **st._asdict())


def _again(try_again) -> dict:
    return dict(try_again=try_again, again_any=try_again.any())


def _final_entries(f: _Final) -> dict:
    return dict({"f_" + k: x for k, x in f._asdict().items()},
                under_any=f.under.any())


def _s_setup(ns):
    st, ctx = _setup(*(ns[k] for k in _INPUTS), ns["cfg"])
    return dict(_ns_of(st, ctx), **_with_done_all(st))


def _s_head(ns):
    st = _ns_state(ns)
    empty_now, go, phase, due = _head(st, ns["cfg"], True)
    out = dict(empty_now=empty_now, go=go, phase=phase, vc=st.v_cur,
               ls=st.log_s, al=st.alive)
    if due is not None:
        out.update(split_due=due, split_any=due.any())
    return out


def _s_split(ns):
    """The split move for the images due: an E-step, then
    :func:`_split_best_vp`."""
    ctx = _ns_ctx(ns)
    _, w = ctx.estep(ns["vc"], ns["al"], ns["ls"])
    vc, ls, al = _split_best_vp(ns["vc"], ns["ls"], ns["al"], w,
                                ns["split_due"], ctx)
    return dict(vc=vc, ls=ls, al=al)


def _s_step(ns):
    st, cfg = _ns_state(ns), ns["cfg"]
    vn, ls, al, converged = _step(st, ns["vc"], ns["ls"], ns["al"],
                                  ns["go"], _ns_ctx(ns))
    out = dict(vn=vn, ls=ls, al=al, converged=converged)
    if cfg.do_merge:
        due = _merge_due(st.i, ns["go"], converged, ns["phase"], cfg)
        out.update(merge_any=due.any(), **_again(_merge_start(al, due)))
    return out


def _s_merge(ns, final: bool):
    cfg = ns["cfg"]
    thresh = cfg.merge_thresh * 10.0 if final else cfg.merge_thresh
    vn, ls, al, again = _merge_step(ns["vn"], ns["ls"], ns["al"],
                                    ns["try_again"], thresh, _ns_ctx(ns))
    return dict(vn=vn, ls=ls, al=al, **_again(again))


def _s_tail(ns):
    return _with_done_all(_tail(
        _ns_state(ns), ns["vc"], ns["vn"], ns["ls"], ns["al"], ns["go"],
        ns["converged"], ns["empty_now"]))


def _s_plain(ns):
    """The plain body: the E-step, the M-step and the swap, split and
    merge left out, so it reads nothing back to the host and runs the
    same ops on the same shapes every time."""
    st = _ns_state(ns)
    empty_now, go, _, _ = _head(st, ns["cfg"], False)
    vn, ls, al, converged = _step(st, st.v_cur, st.log_s, st.alive, go,
                                  _ns_ctx(ns))
    return _with_done_all(_tail(st, st.v_cur, vn, ls, al, go, converged,
                                empty_now))


def _s_final_in(ns):
    st = _ns_state(ns)
    out = dict(vn=st.v_next, ls=st.log_s, al=st.alive)
    if ns["cfg"].do_merge:
        out.update(_again(_merge_start(st.alive, ~st.empty)))
    return out


def _s_final_mid(ns):
    return _final_entries(_final_counts(_ns_state(ns), ns["vn"], ns["ls"],
                                        ns["al"], _ns_ctx(ns)))


def _s_prune(ns):
    return _final_entries(_prune_step(_ns_final(ns), _ns_ctx(ns)))


def _s_final_out(ns):
    return {"r_" + k: x
            for k, x in _result(_ns_final(ns), ns["i"])._asdict().items()}


def _stretches(cfg: EMConfig) -> dict:
    """The stretches a call with ``cfg`` can run, by name, in the order a
    call meets them: the set-up; a full trip's head (gates), split, E/M
    step (up to the merge gate), merge step and tail (the swap); the plain
    trip; the convergence block's stretch before its merge (at 10x the
    threshold), its merge step, the stretch between its merge and prune
    loops (refit, uniqueness filter, first count pass), a prune step and
    the result."""
    s = {"setup": _s_setup, "head": _s_head}
    if cfg.do_split:
        s["split"] = _s_split
    s["step"] = _s_step
    if cfg.do_merge:
        s["merge"] = functools.partial(_s_merge, final=False)
    s.update(tail=_s_tail, plain=_s_plain, final_in=_s_final_in)
    if cfg.do_merge:
        s["final_merge"] = functools.partial(_s_merge, final=True)
    s.update(final_mid=_s_final_mid, prune=_s_prune, final_out=_s_final_out)
    return s


def _store(ns: dict, out: dict) -> None:
    """Write a stretch's results into the buffers of ``ns``, each made on
    the name's first write. A result is a new tensor, or a buffer that the
    stretch does not write (so the copies' order does not matter)."""
    for k, x in out.items():
        if not isinstance(x, torch.Tensor):
            ns[k] = x
        elif k not in ns:
            ns[k] = x.clone()
        elif x is not ns[k]:
            ns[k].copy_(x)


def _capture(step, device: torch.device, shared: dict):
    """``step`` captured as a CUDA graph on ``device``, after one run of it
    on the capture's side stream (``torch.cuda.graphs``' warm-up rule),
    whose counts go nowhere. The captures of one ``shared`` dict use one
    side stream and one memory pool, which the first of them makes -> a
    function that replays the graph there, whichever device is current,
    and makes again the counts the capture held back
    (``profiling.held``)."""
    with torch.cuda.device(device):
        if not shared:
            shared["stream"] = torch.cuda.Stream()
        s = shared["stream"]
        s.wait_stream(torch.cuda.current_stream())
        with profiling.held(), torch.cuda.stream(s):
            step()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with profiling.held() as counts, torch.cuda.graph(
                g, pool=shared.get("pool"), stream=s,
                capture_error_mode="thread_local"):
            step()
        shared["pool"] = g.pool()

    def replay():
        with torch.cuda.device(device):
            g.replay()
        for again in counts:
            again()

    return replay


class _Driver:
    """A call's stretches (:func:`_stretches`) over one set of buffers by
    name, ``ns``: the inputs, the context, the loop state and what each
    stretch hands the next. The host reads the loop's conditions from
    ``ns`` between two stretches. Without ``replays`` each stretch runs op
    by op on ``ns`` as it stands, counted ``em.eager_segments``; a trip is
    :func:`_iteration`. Captured (:meth:`captured`), each stretch is a
    replay of a CUDA graph, counted ``em.graph_segments`` (a plain trip's
    ``em.graph_trips``); a call copies its inputs into the set's own
    buffers and its result out."""

    def __init__(self, ns: dict):
        self.ns, self.cfg = ns, ns["cfg"]
        self.fns = _stretches(self.cfg)
        self.replays: dict | None = None

    @classmethod
    def captured(cls, inputs, cfg: EMConfig) -> "_Driver":
        """Every stretch captured in a call's order, each after one run on
        what the buffers hold then (so no later call captures), all into
        one memory pool: they run one at a time on one stream, and each
        one's results are copied into buffers outside the pool, so none
        reads what another left there."""
        # plain tensors, so calls in and out of inference mode can fill them
        with torch.inference_mode(False):
            d = cls(dict(zip(_INPUTS, (x.clone() for x in inputs)),
                         cfg=cfg))
            shared: dict = {}
            d.replays = {
                name: _capture(functools.partial(d._write, fn),
                               inputs[0].device, shared)
                for name, fn in d.fns.items()}
        return d

    def _write(self, fn) -> None:
        _store(self.ns, fn(self.ns))

    def run(self, name: str) -> None:
        if self.replays is None:
            self.ns.update(self.fns[name](self.ns))
            if name != "plain":
                profiling.count("em.eager_segments")
            return
        self.replays[name]()
        profiling.count("em.graph_trips" if name == "plain"
                        else "em.graph_segments")

    def read(self, flag: str) -> bool:
        return host_bool(self.ns[flag])

    def setup(self, inputs) -> None:
        if self.replays is None:
            self.ns.update(zip(_INPUTS, inputs))
        else:
            for k, x in zip(_INPUTS, inputs):
                self.ns[k].copy_(x)
        self.run("setup")

    def done(self) -> bool:
        return self.read("done_all")

    def trip(self, full: bool) -> None:
        """One trip of the loop, in the span ``vp.em.iteration``."""
        if self.replays is None:
            st = _iteration(_ns_state(self.ns), _ns_ctx(self.ns), full)
            self.ns.update(_with_done_all(st))
            return
        with profiling.span("vp.em.iteration"):
            self._trip(full)

    def _trip(self, full: bool) -> None:
        if not full:
            self.run("plain")
            return
        cfg = self.cfg
        self.run("head")
        if cfg.do_split and self.read("split_any"):
            self.run("split")
        self.run("step")
        if cfg.do_merge and self.read("merge_any"):
            self._merges("merge")
        self.run("tail")

    def _merges(self, name: str) -> None:
        while self.read("again_any"):
            self.run(name)

    def finalize(self) -> EMResult:
        """The reference's convergence block: the final merge at 10x the
        threshold, the per-VP refit, the uniqueness filter, the outlier
        counts and the min-line prune. Captured, the result is in tensors
        of its own: the next call overwrites the buffers."""
        self.run("final_in")
        if self.cfg.do_merge:
            self._merges("final_merge")
        self.run("final_mid")
        while self.read("under_any"):
            self.run("prune")
        self.run("final_out")
        r = [self.ns["r_" + k] for k in EMResult._fields]
        return EMResult(*(r if self.replays is None
                          else (x.clone() for x in r)))


def _iteration(st: _State, ctx: _Ctx, with_split_merge: bool = True
               ) -> _State:
    """One trip from ``st``, op by op, in the span ``vp.em.iteration``: a
    full trip's stretches and host reads, or the plain body
    (``with_split_merge=False``)."""
    with profiling.span("vp.em.iteration"):
        d = _Driver(_ns_of(st, ctx))
        d._trip(with_split_merge)
        return _ns_state(d.ns)


_local = threading.local()


def _graphs() -> dict:
    """This thread's captured stretch sets by key (a set's buffers serve
    one call at a time)."""
    if not hasattr(_local, "graphs"):
        _local.graphs = {}
    return _local.graphs


def _graphs_of(inputs, cfg: EMConfig) -> _Driver | None:
    """The captured stretches for these inputs' device, shapes and layout
    and this configuration, captured now if new; None off
    ``GRAPH_DEVICES`` and past ``GRAPH_CAP``."""
    dev = inputs[0].device
    if dev.type not in GRAPH_DEVICES:
        return None
    key = (dev, cfg, tuple((x.shape, x.dtype, x.stride()) for x in inputs))
    graphs = _graphs()
    if key not in graphs and len(graphs) < GRAPH_CAP:
        graphs[key] = _Driver.captured(inputs, cfg)
    return graphs.get(key)


def expectation_maximisation(l: torch.Tensor, lp: torch.Tensor,
                             cnn_response: torch.Tensor,
                             sphere_image: torch.Tensor, lmask: torch.Tensor,
                             cfg: EMConfig = EMConfig()) -> EMResult:
    """Run the full EM on a batch.

    l (B, N, 3) homogeneous lines (row-normalized here), lp (B, N, 4)
    segments, cnn_response (B, 20, 20) sigmoid grids, sphere_image
    (B, S, S) in Agg orientation, lmask (B, N) validity."""
    with profiling.span("vp.em"):
        inputs = (l, lp, cnn_response, sphere_image, lmask)
        em = _graphs_of(inputs, cfg) or _Driver({"cfg": cfg})
        with profiling.span("vp.em.setup"):
            em.setup(inputs)
        t = 0
        while not em.done():
            if cfg.loop == "phase":
                em.trip(True)
                for _ in range(cfg.split_merge_freq - 1):
                    em.trip(False)
            else:
                em.trip(_full_trip(t, cfg))
            t += 1
        with profiling.span("vp.em.finalize"):
            return em.finalize()
