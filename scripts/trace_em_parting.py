"""Find where the port's EM parts from the JAX EM's, op by op, on the CPU.

Reads the populations of ``assets/examples/jax_reference_em.npz``
(``scripts/make_jax_reference_em.py``) and, for each one named, runs the
JAX EM's loop body (``em/em.py``'s uniform body, composed here of the JAX
package's own functions: ``_split_best_vp``, ``calc_probabilities``,
``weight_matrix``, ``calc_new_vanishing_point``, ``_s_update_log``,
``_merge_vps``) one iteration at a time, and feeds each iteration's JAX
state to the port's loop body (``em.em._iteration``) as well: the first
iteration whose outputs differ between the packages GIVEN THE SAME STATE
is where they part. For every VP refit that differs by more than 1e-6
(1 - |cos|) it prints the slot, the difference and the eigenvalues of the
slot's weighted gram relative to its largest (float64), and names the
refits whose closed form took the degenerate branch in one package only.

``--agreement`` counts, per checkpoint, the populations on which the
port's batch-1 EM follows JAX's. ``--audit NAME`` compares the ops of
the first iterations on the same state against float64 (the port's
functions in float64 on the same float32 inputs): the relative errors of
JAX's and of the port's float32 results.
``--fma`` checks how XLA:CPU evaluates a sum of two products and a
multiply-add (one fused multiply-add, the first product rounded) against
the port. ``--first_call N`` runs ``torch.sqrt`` on a 639x639 tensor in N
fresh processes and counts those whose first call rounds differently
from their second.

The JAX replica is not the jitted ``expectation_maximisation`` (a body
compiled on its own may round differently from the whole program); it
serves to compare the two packages' ops on one state, not to reproduce
the oracle.

    python scripts/trace_em_parting.py [NAME ...] [--agreement]
        [--audit NAME] [--fma] [--first_call N]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "assets", "examples", "jax_reference_em.npz")


def _setup():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")


def jax_body(st, ctx, cfg):
    """``em/em.py``'s uniform loop body on one image, from the JAX
    package's functions -> (state, max_err)."""
    import jax
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.em import em as jem
    from vanishing_points_2017_tpu.em import weights as jw
    from vanishing_points_2017_tpu.ops import probability as jprob

    pdf, l, lp, lmask, lw, lsim, la = ctx

    def estep(v, alive, log_s):
        p = jprob.calc_probabilities(pdf, v, alive, l, lp, log_s, lmask,
                                     cfg.distance_measure, cfg.wrap_quirk)
        return p, jw.weight_matrix(p.p_vl, lw, lsim, bias=cfg.wbias)

    i, v_cur, v_next, log_s, alive = (st.i, st.v_cur, st.v_next, st.log_s,
                                      st.alive)
    empty_now = jnp.sum(alive) == 0
    go = ~st.done & ~empty_now
    freq = cfg.split_merge_freq
    split_due = go & (i % freq == 0) & (i > 0) & (i < jem.SPLIT_MERGE_IT)
    _, w_s = estep(v_cur, alive, log_s)
    v_cur, log_s, alive = jem._split_best_vp(v_cur, log_s, alive, w_s, l, lp,
                                             lmask, lw, la, split_due, cfg)
    p, w = estep(v_cur, alive, log_s)
    new_vps, vp_ok = jax.vmap(jw.calc_new_vanishing_point,
                              in_axes=(None, 0))(l, w)
    s_new = jnp.clip(jax.vmap(jem._s_update_log, in_axes=(1, 0))(p.lvsq,
                                                                  p.p_vl),
                     jem.LOG_S_THRESH, jnp.log(cfg.max_stdd))
    s_nan = jnp.isnan(s_new)
    v_next2 = jnp.where((alive & vp_ok)[:, None], new_vps, v_cur)
    err = jem._vp_change(v_cur, v_next2)
    contributes = alive & vp_ok & ~s_nan
    max_err = jnp.max(jnp.where(contributes, err, 0.0))
    removed = alive & (~vp_ok | s_nan | (contributes & (err > 1.5)))
    v_next = jnp.where(go, v_next2, v_next)
    log_s = jnp.where(go, jnp.where(alive & vp_ok, s_new, log_s), log_s)
    alive = jnp.where(go, alive & ~removed, alive)
    converged = (max_err < cfg.final_convergence) | (i == cfg.num_iter - 1)
    merge_due = go & ~converged & (i % freq == 0) & (i > 0) & (
        i <= jem.SPLIT_MERGE_IT + freq)
    v_next, log_s, alive = jem._merge_vps(v_next, log_s, alive,
                                          cfg.merge_thresh, merge_due, pdf,
                                          l, lp, lmask, lw, lsim, cfg)
    swap = go & ~converged
    return jem._State(i=jnp.where(swap, i + 1, i),
                      v_cur=jnp.where(swap, v_next, v_cur), v_next=v_next,
                      log_s=log_s, alive=alive,
                      done=st.done | (go & converged) | empty_now,
                      empty=st.empty | (~st.done & empty_now)), max_err


def jax_setup(row: dict, cfg):
    """The JAX EM's constants and first state for one population."""
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.em import em as jem
    from vanishing_points_2017_tpu.em import init_vps
    from vanishing_points_2017_tpu.em import weights as jw
    from vanishing_points_2017_tpu.ops import lines as jl
    from vanishing_points_2017_tpu.ops import probability as jprob

    m = jnp.asarray(row["lmask"])
    l = jnp.where(m[:, None], jl.normalize_rows(jnp.asarray(row["l"])), 0.0)
    lp = jnp.where(m[:, None], jnp.asarray(row["lp"]), 0.0)
    grid = jnp.asarray(row["grid"])
    lsim = jl.calc_lsim(lp, m, sigma=1.0)
    lw = jnp.where(m, jl.line_length(lp) * jnp.clip(
        jl.line_rating_knn(lp, m, k1=10, k2=4, sigma=1.0), 0.2, 1.0), 0.0)
    pdf = jprob.pdf_params(grid)
    v0, alive = init_vps.find_initial_vps(
        jnp.asarray(row["sphere"]).astype(jnp.float32), grid,
        cfg.num_init_vp, cfg.m_slots)
    log_s = jnp.full((cfg.m_slots,), jnp.log(pdf.sigma * cfg.s_init_factor))
    p = jprob.calc_probabilities(pdf, v0, alive, l, lp, log_s, m)
    counts, _, _ = jw.calc_vp_line_counts(
        v0, alive, l, lp, m, log_s, jw.weight_matrix(p.p_vl, lw, lsim), lw,
        cfg.distance_measure, thresh=cfg.outlier_thresh)
    st = jem._State(i=jnp.zeros((), jnp.int32), v_cur=v0,
                    v_next=jnp.zeros_like(v0), log_s=log_s,
                    alive=alive & (counts >= 3), done=jnp.zeros((), bool),
                    empty=jnp.zeros((), bool))
    return st, (pdf, l, lp, m, lw, lsim, jl.lines_angles(lp))


def _port_state(st):
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.em import em as tem

    def t(x):
        a = torch.from_numpy(np.array(x))[None]
        return a.long() if a.dtype == torch.int32 else a
    return tem._State(*(t(getattr(st, k)) for k in tem._State._fields))


def gram_eigs(l, w) -> "np.ndarray":
    """Eigenvalues (ascending, float64) of diag(w / max w) L's gram,
    relative to the largest."""
    import numpy as np

    w = np.asarray(w, np.float64)
    lw = np.asarray(l, np.float64) * (w / w.max())[:, None]
    ev = np.linalg.eigvalsh(lw.T @ lw)
    return ev / ev[-1]


def trace(name: str, ref: dict) -> None:
    """The synchronized walk of one population."""
    import jax
    import numpy as np
    import torch

    from vanishing_points_2017_tpu.em import em as jem
    from vanishing_points_2017_tpu.em import weights as jw
    from vanishing_points_2017_tpu.ops import probability as jprob
    from vanishing_points_2017_tpu_torch.em import em as tem
    from vanishing_points_2017_tpu_torch.em import weights as tw

    i = list(ref["names"]).index(name)
    row = {k: ref[k][i] for k in ("l", "lp", "lmask", "sphere", "grid")}
    cfg = jem.EMConfig()
    st, ctx = jax.jit(jax_setup, static_argnums=1)(row, cfg)
    t = lambda k: torch.from_numpy(np.array(row[k]))[None]
    _, tctx = tem._setup(t("l"), t("lp"), t("grid"), t("sphere").float(),
                         t("lmask"), tem.EMConfig())
    body = jax.jit(jax_body, static_argnums=2)
    print(f"{name}: JAX {int(ref['end_iterations'][i])} iterations")
    while not bool(st.done):
        nxt, _ = body(st, ctx, cfg)
        got = tem._iteration(_port_state(st), tctx)
        ja, ta = np.asarray(nxt.alive), got.alive[0].numpy()
        both = ja & ta
        cos = np.abs(np.sum(np.asarray(nxt.v_next, np.float64)
                            * got.v_next[0].numpy(), -1))
        it = int(st.i)
        if not np.array_equal(ja, ta):
            print(f"  iteration {it}: alive JAX-only "
                  f"{np.flatnonzero(ja & ~ta).tolist()}, port-only "
                  f"{np.flatnonzero(ta & ~ja).tolist()}")
        if bool(nxt.done) != bool(got.done[0]):
            print(f"  iteration {it}: JAX done {bool(nxt.done)}, port "
                  f"{bool(got.done[0])}")
        pdf, l, lp, m, lw, lsim, _ = ctx
        p = jprob.calc_probabilities(pdf, st.v_cur, st.alive, l, lp, st.log_s,
                                     m)
        w = np.asarray(jw.weight_matrix(p.p_vl, lw, lsim))
        far = np.flatnonzero(np.where(both, 1.0 - cos, 0.0) > 1e-6)
        if far.size or not np.array_equal(ja, ta):
            jv = np.asarray(jax.vmap(jw.calc_new_vanishing_point,
                                     in_axes=(None, 0))(l, w)[0])
            tv = tw.calc_new_vanishing_point(
                torch.from_numpy(np.array(l))[None],
                torch.from_numpy(w)[None])[0][0].numpy()
            for s in np.flatnonzero(np.asarray(st.alive)):
                zj, zt = not np.any(jv[s]), not np.any(tv[s])
                if zj != zt:
                    ev = gram_eigs(l, w[s])
                    print(f"  iteration {it}: slot {s}: the refit is the zero "
                          f"vector (degenerate branch) in "
                          f"{'JAX' if zj else 'the port'} only; gram "
                          f"eigenvalues {ev[0]:.2g}, {ev[1]:.2g} of the "
                          "largest")
        for s in far:
            ev = gram_eigs(l, w[s])
            print(f"  iteration {it}: slot {s}: VPs 1 - |cos| "
                  f"{1.0 - cos[s]:.2g} apart; gram eigenvalues {ev[0]:.2g}, "
                  f"{ev[1]:.2g} of the largest")
        st = nxt


def audit(name: str, ref: dict, iterations: int = 3) -> None:
    """JAX's and the port's float32 ops against float64 on the same
    state, over the first iterations."""
    import jax
    import numpy as np
    import torch

    from vanishing_points_2017_tpu.em import em as jem
    from vanishing_points_2017_tpu.em import weights as jw
    from vanishing_points_2017_tpu.ops import probability as jprob
    from vanishing_points_2017_tpu_torch.em import em as tem
    from vanishing_points_2017_tpu_torch.em import weights as tw
    from vanishing_points_2017_tpu_torch.ops import probability as tprob

    i = list(ref["names"]).index(name)
    row = {k: ref[k][i] for k in ("l", "lp", "lmask", "sphere", "grid")}
    cfg = jem.EMConfig()
    st, ctx = jax.jit(jax_setup, static_argnums=1)(row, cfg)
    pdf, l, lp, m, lw, lsim, _ = ctx
    body = jax.jit(jax_body, static_argnums=2)

    def t(x, dt):
        a = torch.from_numpy(np.array(x))[None]
        return a.to(dt) if a.is_floating_point() else a

    def rel(tag, j, p32, p64):
        j, p32 = np.asarray(j, np.float64), p32[0].double().numpy()
        p64 = p64[0].numpy()
        ok = np.isfinite(j) & np.isfinite(p32) & np.isfinite(p64)
        scale = np.maximum(np.abs(p64[ok]), 1e-30)
        ej, ep = (np.abs(x[ok] - p64[ok]) / scale for x in (j, p32))
        print(f"  {tag:10s} relative error against float64: JAX median "
              f"{np.median(ej):.2g} max {ej.max():.2g}; port median "
              f"{np.median(ep):.2g} max {ep.max():.2g}")

    for _ in range(iterations):
        print(f"{name} iteration {int(st.i)}:")
        pj = jprob.calc_probabilities(pdf, st.v_cur, st.alive, l, lp,
                                      st.log_s, m)
        pt = {}
        for dt in (torch.float32, torch.float64):
            tp = tprob.PDFParams(torch.from_numpy(np.array(pdf.means)).to(dt),
                                 t(pdf.weights, dt), float(pdf.sigma))
            pt[dt] = tprob.calc_probabilities(
                tp, t(st.v_cur, dt), t(st.alive, dt), t(l, dt), t(lp, dt),
                t(st.log_s, dt), t(m, dt))
        for k in ("angles", "p_v", "log_pl", "p_vl"):
            rel(k, getattr(pj, k), getattr(pt[torch.float32], k),
                getattr(pt[torch.float64], k))
        wj = jw.weight_matrix(pj.p_vl, lw, lsim)
        rel("weights", wj, *(tw.weight_matrix(t(pj.p_vl, dt), t(lw, dt),
                                              t(lsim, dt))
                             for dt in (torch.float32, torch.float64)))
        sj = jax.vmap(jem._s_update_log, in_axes=(1, 0))(pj.lvsq, pj.p_vl)
        a = np.asarray(st.alive)
        s32, s64 = (tem._s_update_log(t(pj.lvsq, dt).transpose(1, 2),
                                      t(pj.p_vl, dt))
                    for dt in (torch.float32, torch.float64))
        e_jax = np.abs(np.asarray(sj, np.float64) - s64[0].numpy())[a]
        e_port = np.abs((s32[0].double() - s64[0]).numpy())[a]
        print(f"  log s     largest error against float64: JAX "
              f"{e_jax.max():.2g}, port {e_port.max():.2g}")
        st, _ = body(st, ctx, cfg)
        if bool(st.done):
            break


def fma_check() -> None:
    """How XLA:CPU evaluates a0*b0 + a1*b1 and a*b + c."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(100000, 2)).astype(np.float32) for _ in "ab")
    c = rng.normal(size=100000).astype(np.float32)
    dot = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, -1))(a, b))
    p0 = a[:, 0] * b[:, 0]
    fused = (a[:, 1].astype(np.float64) * b[:, 1] + p0).astype(np.float32)
    port = torch.sum(torch.from_numpy(a) * torch.from_numpy(b), -1).numpy()
    print(f"sum(a * b) over 2: JAX equals fma(a1, b1, round(a0 b0)) on "
          f"{np.mean(dot == fused):.4f} of 100000, the port's product-then-"
          f"sum on {np.mean(dot == port):.4f}")
    x, y = a[:, 0], b[:, 0]
    mad = np.asarray(jax.jit(lambda x, y, c: x * y + c)(x, y, c))
    one = (x.astype(np.float64) * y + c).astype(np.float32)
    two = (torch.from_numpy(x) * torch.from_numpy(y)
           + torch.from_numpy(c)).numpy()
    print(f"a * b + c: JAX equals one fma on {np.mean(mad == one):.4f}, "
          f"the port's product-then-add on {np.mean(mad == two):.4f}")


def agreement(ref: dict) -> None:
    """Per checkpoint, on how many populations the port's batch-1 EM on
    the CPU gives JAX's iterations, alive set and VPs (1 - |cos| <= 1e-6),
    and the end horizons' largest gap to JAX's."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.data.io import \
        normalized_horizon_error
    from vanishing_points_2017_tpu_torch.em import em as tem
    from vanishing_points_2017_tpu_torch.em.horizon import \
        calculate_horizon_and_ortho_vp

    t = lambda k, i: torch.from_numpy(np.array(ref[k][i]))[None]
    n = len(ref["names"])
    for tag, num_iter in (("it1", 1), ("it2", 2), ("it3", 3), ("end", 100)):
        same, gaps = 0, []
        for i in range(n):
            em = tem.expectation_maximisation(
                t("l", i), t("lp", i), t("grid", i), t("sphere", i).float(),
                t("lmask", i), tem.EMConfig(num_iter=num_iter))
            alive = em.alive[0].numpy()
            cos = np.abs(np.sum(em.vp[0].double().numpy()
                                * ref[f"{tag}_vp"][i], -1))
            same += bool(int(em.iterations[0]) == ref[f"{tag}_iterations"][i]
                         and np.array_equal(alive, ref[f"{tag}_alive"][i])
                         and np.all(1.0 - cos[alive] <= 1e-6))
            if tag == "end":
                hp1, hp2, *_ = calculate_horizon_and_ortho_vp(
                    em.vp, em.counts, em.alive, maxbest=20,
                    theta_vmin=float(np.pi / 10), pos_gate_ideal_tol=8.0)
                line = lambda a, b: np.cross(np.asarray(a, np.float64),
                                             np.asarray(b, np.float64))
                gaps.append(normalized_horizon_error(
                    line(hp1[0], hp2[0]), line(ref["hp1"][i], ref["hp2"][i]),
                    640, 640))
        print(f"{tag}: the port follows JAX on {same} of {n}" + (
            f"; end horizons within {max(gaps):.5f} of JAX's" if gaps
            else ""))


FIRST_CALL = """
import numpy as np, torch
g = torch.Generator().manual_seed(0)
x = (torch.rand(1, 639, 639, generator=g) * 100) ** 2
a, b = torch.sqrt(x), torch.sqrt(x)
print(int((a != b).sum()))
"""


def first_call(n: int) -> None:
    """``torch.sqrt``'s first call against its second in ``n`` processes."""
    counts = [int(subprocess.run([sys.executable, "-c", FIRST_CALL],
                                 capture_output=True, text=True,
                                 check=True).stdout) for _ in range(n)]
    print(f"torch.sqrt on 639x639: the first call differs from the second "
          f"in {sum(c > 0 for c in counts)} of {n} processes (elements "
          f"differing: {counts})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--audit")
    ap.add_argument("--fma", action="store_true")
    ap.add_argument("--agreement", action="store_true")
    ap.add_argument("--first_call", type=int, default=0)
    args = ap.parse_args()
    _setup()
    import numpy as np

    ref = dict(np.load(REF))
    for name in args.names:
        trace(name, ref)
    if args.audit:
        audit(args.audit, ref)
    if args.agreement:
        agreement(ref)
    if args.fma:
        fma_check()
    if args.first_call:
        first_call(args.first_call)


if __name__ == "__main__":
    main()
