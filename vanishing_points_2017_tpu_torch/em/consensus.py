"""Bootstrap-consensus horizon (``em/consensus.py`` of the JAX package).

The horizon is the argmax over triplet scores, and on texture-heavy
photographs the top two triplets can score within a few percent of each
other, so a sub-pixel change of the segment population flips the winner.
The consensus estimator runs the EM and the horizon search on K
populations (member 0 is the untouched one; members 1..K-1 keep a random
85% subset in "dropout" mode, or resample with replacement in
"bootstrap" mode) and reports the MEDOID member: the one whose horizon
heights at x = +-1 lie jointly closest (L1) to the per-edge median over
the valid members. A medoid, not an average, so every reported output is
one self-consistent EM result. The sphere image and the CNN prior are
shared by all members.

Here the K members of the B images run as ONE batch of K * B through the
batched EM and horizon search (:func:`em_and_horizon`, the pipeline's
single-EM stage too), member-major, so member 0 of image b meets exactly
the kernels the single EM gives image b and reproduces it bit for bit.
The member draws come from a
``torch.Generator`` seeded with ``seed`` (on the CPU, then moved to the
device, so CPU and GPU runs draw the same members); they are therefore
NOT the draws of the JAX package's ``jax.random.PRNGKey(seed)``, and only
member 0 is the same population in both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..batching import in_chunks
from .em import EMConfig, EMResult, expectation_maximisation
from .horizon import calculate_horizon_and_ortho_vp


def em_and_horizon(l: torch.Tensor, lp: torch.Tensor, pred: torch.Tensor,
                   sphere_image: torch.Tensor, lmask: torch.Tensor,
                   em_cfg: EMConfig, **horizon_args):
    """The EM and the horizon search on a batch, in fixed chunks of
    images (``batching.in_chunks``: 32 on a GPU, padded with line-less
    images, which end at the first EM iteration; one on the CPU), so an
    image's VPs and horizon do not depend on its batch. -> (EMResult, the
    6-tuple of :func:`calculate_horizon_and_ortho_vp`)."""
    def run(l, lp, pred, sphere_image, lmask):
        em = expectation_maximisation(l, lp, pred, sphere_image, lmask,
                                      em_cfg)
        return em, calculate_horizon_and_ortho_vp(em.vp, em.counts, em.alive,
                                                  **horizon_args)

    return in_chunks(run, [l, lp, pred, sphere_image, lmask])


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` along the last dim, with static shapes
    (invalid entries sort to +inf); ``x[..., 0]`` where nothing is valid."""
    xs = torch.sort(torch.where(mask, x, math.inf), dim=-1).values
    nv = mask.sum(-1, keepdim=True)
    lo = torch.gather(xs, -1, torch.clamp(torch.div(nv - 1, 2,
                                                    rounding_mode="floor"),
                                          min=0))
    hi = torch.gather(xs, -1, nv // 2)
    med = (0.5 * (lo + hi))[..., 0]
    return torch.where(nv[..., 0] > 0, med, x[..., 0])


def bootstrap_populations(l: torch.Tensor, lp: torch.Tensor,
                          lmask: torch.Tensor, k: int, seed: int,
                          mode: str = "bootstrap", drop: float = 0.15):
    """(l, lp, lmask) of B images -> K stacked populations (K, B, N, ...);
    member 0 is the original.

    Each image's rows are put valid-first (a stable order). "bootstrap":
    members draw n_valid rows with replacement from the valid ones.
    "dropout": members keep a random (1 - ``drop``) fraction of the valid
    rows without replacement, compacted to the front. Member masks are
    dense prefixes."""
    b, n = lmask.shape
    dev = lmask.device
    order = torch.argsort((~lmask).to(torch.uint8), dim=1, stable=True)
    n_valid = lmask.sum(1)
    nv1 = torch.clamp(n_valid, min=1)
    rows = torch.arange(n, device=dev)
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((k - 1, b, n), generator=gen).to(dev)
    if mode == "dropout":
        keep = torch.tensor(1.0 - drop, dtype=torch.float32)
        n_keep = torch.clamp((nv1.to(torch.float32) * keep.to(dev))
                             .to(torch.int64), min=1)
        mask_boot = rows < n_keep[:, None]
        u = torch.where(rows < n_valid[:, None], u, math.inf)
        idx = torch.argsort(u, dim=-1, stable=True)
    elif mode == "bootstrap":
        mask_boot = rows < n_valid[:, None]
        idx = torch.minimum((u * nv1[:, None]).to(torch.int64),
                            (nv1 - 1)[:, None])
    else:
        raise ValueError(f"mode {mode!r}: expected 'dropout' or 'bootstrap'")
    src = torch.gather(order.expand(k - 1, b, n), 2, idx)  # original rows
    bi = torch.arange(b, device=dev)[None, :, None]
    l_all = torch.cat([l[None], l[bi, src]])
    lp_all = torch.cat([lp[None], lp[bi, src]])
    m_all = torch.cat([lmask[None], mask_boot.expand(k - 1, b, n)])
    return l_all, lp_all, m_all


def medoid_pick(yl: torch.Tensor, yr: torch.Tensor, valid: torch.Tensor,
                guard: float = 0.0) -> torch.Tensor:
    """Members' horizon heights at x = -1/+1 and validity, (B, K) each ->
    the picked member per image: the valid member closest (L1 over both
    edges) to the per-edge median of the valid members, the first on a
    tie, member 0 when none is valid. ``guard`` > 0 keeps member 0 when
    it is valid and within ``guard`` of the medians."""
    med_l, med_r = masked_median(yl, valid), masked_median(yr, valid)
    dist = torch.where(valid, (yl - med_l[:, None]).abs()
                       + (yr - med_r[:, None]).abs(), math.inf)
    pick = torch.where(valid.any(1), torch.argmin(dist, dim=1), 0)
    if guard > 0.0:
        pick = torch.where(valid[:, 0] & (dist[:, 0] <= guard), 0, pick)
    return pick


def member_em_horizon(l_all: torch.Tensor, lp_all: torch.Tensor,
                      m_all: torch.Tensor, pred: torch.Tensor,
                      sphere_image: torch.Tensor, em_cfg: EMConfig, *,
                      guard: float = 0.0, maxbest: int = 20,
                      theta_vmin: float = float(np.pi / 10),
                      pos_gate_ideal_tol: float = float("inf")):
    """K populations (K, B, N, ...) through the EM and the horizon search
    as one batch of K * B; returns the medoid member of each image as
    ``(em, horizon 6-tuple, diag)`` (see :func:`consensus_em_horizon`)."""
    k, b = m_all.shape[:2]

    def flat(x):
        return x.reshape(k * b, *x.shape[2:])

    def shared(x):
        return flat(x[None].expand(k, *x.shape))

    emr, hz = em_and_horizon(flat(l_all), flat(lp_all), shared(pred),
                             shared(sphere_image), flat(m_all), em_cfg,
                             maxbest=maxbest, theta_vmin=theta_vmin,
                             pos_gate_ideal_tol=pos_gate_ideal_tol)
    hp1, hp2 = (h.reshape(k, b, 3) for h in hz[:2])
    yl, yr = hp1[..., 1].T, hp2[..., 1].T            # (B, K)
    valid = emr.valid.reshape(k, b).T
    pick = medoid_pick(yl, yr, valid, guard)
    bi = torch.arange(b, device=pick.device)

    def take(x):
        return x.reshape(k, b, *x.shape[1:])[pick, bi]

    spread_l = (torch.where(valid, yl, -math.inf).amax(1)
                - torch.where(valid, yl, math.inf).amin(1))
    spread_r = (torch.where(valid, yr, -math.inf).amax(1)
                - torch.where(valid, yr, math.inf).amin(1))
    diag = {
        "consensus_yl": yl, "consensus_yr": yr,
        "consensus_valid": valid, "consensus_pick": pick,
        "consensus_spread": torch.where(valid.any(1),
                                        torch.maximum(spread_l, spread_r),
                                        math.inf),
    }
    return EMResult(*(take(x) for x in emr)), tuple(take(h) for h in hz), diag


def consensus_em_horizon(l: torch.Tensor, lp: torch.Tensor,
                         pred: torch.Tensor, sphere_image: torch.Tensor,
                         lmask: torch.Tensor, em_cfg: EMConfig, *, k: int,
                         seed: int = 0, mode: str = "dropout",
                         guard: float = 0.0, maxbest: int = 20,
                         theta_vmin: float = float(np.pi / 10),
                         pos_gate_ideal_tol: float = float("inf")):
    """K-member consensus EM + horizon on a batch; returns the medoid
    member per image as ``(em: EMResult, horizon: 6-tuple, diag: dict)``.

    The 6-tuple is :func:`calculate_horizon_and_ortho_vp`'s return for the
    picked members; ``diag`` holds per image the members' horizon heights
    at x = -1 and +1 (``consensus_yl``/``consensus_yr``, (B, K)), their
    validity, the picked index and the valid members' edge spread.
    ``guard`` > 0 keeps member 0 whenever its summed edge deviation from
    the member median is within ``guard``."""
    l_all, lp_all, m_all = bootstrap_populations(l, lp, lmask, k, seed,
                                                 mode=mode)
    return member_em_horizon(l_all, lp_all, m_all, pred, sphere_image, em_cfg,
                             guard=guard, maxbest=maxbest,
                             theta_vmin=theta_vmin,
                             pos_gate_ideal_tol=pos_gate_ideal_tol)
