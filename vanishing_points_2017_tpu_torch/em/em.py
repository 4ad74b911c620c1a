"""Expectation-maximisation VP refinement (``em/em.py`` of the JAX package),
batched over images.

VPs live in ``m_slots`` fixed slots with an ``alive`` mask (delete = mask
off, split = write into the first free slot, merge = write + mask off);
lines are padded with an ``lmask``; variances are carried as ``log s``.
The JAX ``lax.while_loop`` bodies become Python loops over batched state:
every loop runs while ANY image still needs it, and an image whose own
condition is false keeps its state unchanged — what a vmapped
``while_loop`` does. The loop conditions are read on the host, one
device-to-host sync per iteration.

``EMConfig.loop`` picks the JAX package's loop structure. ``"uniform"``
(the default) runs one body per trip, with split and merge gated by
``i % split_merge_freq``; a split or merge step with no image due is
skipped outright, which leaves every state unchanged, as the gated JAX
body does. ``"phase"`` runs one full body and then
``split_merge_freq - 1`` bodies with split and merge statically off per
trip: the images advance in lockstep (each either moves one iteration or
is done), so none is due in those bodies, and they read nothing back;
``done`` is read once per trip. Its outputs are bit-identical to the
uniform loop's; bodies run on images already done leave them unchanged.

Reference quirks kept (see the JAX module): split's in-image check on the
raw slot index, merge writing s[k] before validating, NaN stddevs sorting
first in the split order, the hardcoded count < 3 initial prune.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops import lines as lineops
from ..ops import probability as prob
from . import cluster as clust
from . import init_vps
from . import weights as wmod

LOG_S_THRESH = prob.LOG_S_FLOOR  # log(1e-200)
SPLIT_MERGE_IT = 100  # reference hardcodes split_merge_it = 100
MERGE_MAX_STDD = 0.01  # merge_vps' own default max_stdd


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


def _merge_vps(v, log_s, alive, thresh: float, go, ctx: _Ctx):
    """Masked ``merge_vps``: repeatedly merge each image's closest alive VP
    pair (j < k: j deleted, k keeps the merged VP) while its angle is below
    ``thresh``; s[k] is written before the acceptance check (the
    reference's mutation-on-rejection quirk)."""
    b, ms, _ = v.shape
    bi = torch.arange(b, device=v.device)
    slots = torch.arange(ms, device=v.device)[None]
    log_max = _f32log(MERGE_MAX_STDD)
    try_again = go & (torch.sum(alive, dim=1) > 1)
    while bool(try_again.any()):
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
        accept = vp_ok & ~(s_k > log_max)
        is_k = slots == k[:, None]
        log_s2 = torch.where(is_k, s_k[:, None], log_s)
        take = (accept & mergeable)[:, None]
        v2 = torch.where((is_k & take)[..., None], new_vp[:, None], v)
        alive2 = alive & ~((slots == j[:, None]) & take)

        upd = try_again & mergeable
        v = _sel(upd, v2, v)
        log_s = _sel(upd, log_s2, log_s)
        alive = _sel(upd, alive2, alive)
        try_again = upd & accept & (torch.sum(alive, dim=1) > 1)
    return v, log_s, alive


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


def _finalize(st: _State, ctx: _Ctx) -> EMResult:
    """The reference's convergence block: final merge at 10x threshold,
    per-VP refit from argmax-assigned lines, uniqueness filter, outlier
    counting and iterative min-line pruning."""
    i, v_cur, v_next, log_s, alive, _, empty = st
    cfg = ctx.cfg
    b, ms, _ = v_cur.shape
    dev = v_cur.device
    slots = torch.arange(ms, device=dev)[None]
    go = ~empty

    if cfg.do_merge:
        v_next, log_s, alive = _merge_vps(v_next, log_s, alive,
                                          cfg.merge_thresh * 10.0, go, ctx)

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

    def count_pass(alive):
        _, dm3 = ctx.estep(v_next, alive, log_s)
        counts, cw, assoc3 = wmod.calc_vp_line_counts(
            v_next, alive, ctx.l, ctx.lp, ctx.lmask, log_s, dm3, ctx.lweight,
            cfg.distance_measure, thresh=cfg.outlier_thresh)
        return counts, cw, assoc3, dm3

    counts, cw, assoc3, dm3 = count_pass(alive)
    under = alive & (counts < cfg.num_min_lines)
    while bool(under.any()):
        prune = under.any(dim=1)
        vidx = torch.argmax(under.to(torch.uint8), dim=1)  # lowest slot
        alive2 = alive & (slots != vidx[:, None])
        c2, w2, a2, d2 = count_pass(alive2)
        alive = _sel(prune, alive2, alive)
        counts = _sel(prune, c2, counts)
        cw = _sel(prune, w2, cw)
        assoc3 = _sel(prune, a2, assoc3)
        dm3 = _sel(prune, d2, dm3)
        under = alive & (counts < cfg.num_min_lines)

    valid = ~empty2 & (torch.sum(alive, dim=1) > 0)
    zero = lambda x: _sel(valid, x, torch.zeros_like(x))
    return EMResult(
        vp=torch.where((alive & valid[:, None])[..., None], v_next, 0.0),
        alive=alive & valid[:, None],
        vp_assoc=_sel(valid, assoc3, torch.full_like(assoc3, -1)),
        counts=zero(counts), counts_weighted=zero(cw),
        decision_metric=zero(dm3), log_sigma=log_s, iterations=i,
        valid=valid)


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


def _iteration(st: _State, ctx: _Ctx, with_split_merge: bool = True
               ) -> _State:
    """One pass of the loop body for every image not yet done: the split
    move when due, the E-step, the M-step (weighted TLS refit and
    variance update), the periodic merge when due, the buffer swap.
    ``with_split_merge=False`` leaves split and merge out (the phase
    loop's plain bodies), so the body reads nothing back to the host."""
    cfg, l = ctx.cfg, ctx.l
    i, v_cur, v_next, log_s, alive, done, empty = st
    b = l.shape[0]
    freq = cfg.split_merge_freq
    empty_now = torch.sum(alive, dim=1) == 0
    go = ~done & ~empty_now
    phase = (torch.remainder(i, freq) == 0) & (i > 0)
    vc, ls, al = v_cur, log_s, alive

    # ---- split move (every split_merge_freq iterations, 0 < i < 100)
    if cfg.do_split and with_split_merge:
        split_due = go & phase & (i < SPLIT_MERGE_IT)
        if bool(split_due.any()):
            _, w_s = ctx.estep(vc, al, ls)
            vc, ls, al = _split_best_vp(vc, ls, al, w_s, split_due, ctx)

    # ---- E-step + M-step: weighted TLS refit + variance update
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
        max_err = torch.zeros(b, dtype=torch.float32, device=l.device)
    vn = _sel(go, v_next2, v_next)
    ls = _sel(go, log_s2, ls)
    al = _sel(go, alive2, al)
    converged = ((max_err < cfg.final_convergence) | (i == cfg.num_iter - 1)
                 | (not cfg.do_iterations))

    # ---- periodic merge (only when not converged this iteration)
    if cfg.do_merge and with_split_merge:
        merge_due = (go & ~converged & phase
                     & (i <= SPLIT_MERGE_IT + freq))
        if bool(merge_due.any()):
            vn, ls, al = _merge_vps(vn, ls, al, cfg.merge_thresh,
                                    merge_due, ctx)

    # buffer swap for the next iteration; images already done keep
    # their whole state, as under a vmapped while_loop
    swap = go & ~converged
    run = ~done
    return _State(i=torch.where(swap, i + 1, i),
                  v_cur=_sel(run, _sel(swap, vn, vc), v_cur),
                  v_next=_sel(run, vn, v_next), log_s=_sel(run, ls, log_s),
                  alive=_sel(run, al, alive), done=done | (go & converged)
                  | empty_now, empty=empty | (run & empty_now))


def expectation_maximisation(l: torch.Tensor, lp: torch.Tensor,
                             cnn_response: torch.Tensor,
                             sphere_image: torch.Tensor, lmask: torch.Tensor,
                             cfg: EMConfig = EMConfig()) -> EMResult:
    """Run the full EM on a batch.

    l (B, N, 3) homogeneous lines (row-normalized here), lp (B, N, 4)
    segments, cnn_response (B, 20, 20) sigmoid grids, sphere_image
    (B, S, S) in Agg orientation, lmask (B, N) validity."""
    st, ctx = _setup(l, lp, cnn_response, sphere_image, lmask, cfg)
    plain = max(cfg.split_merge_freq - 1, 0) if cfg.loop == "phase" else 0
    while not bool(st.done.all()):
        st = _iteration(st, ctx)
        for _ in range(plain):
            st = _iteration(st, ctx, with_split_merge=False)
    return _finalize(st, ctx)
