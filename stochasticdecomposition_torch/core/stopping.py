"""Optimality tests: pre-test and the bootstrap full test.

Reference: optimal.c.  The full test (optimal.c:69-133) resamples the
empirical distribution BOOTSTRAP_REP times, reforms the "good" cuts from the
stored iStar indices (reformCuts, optimal.c:187-236), and compares the upper
estimate against the closed-form QP dual lower bound (calcBootstrpLB,
optimal.c:240-338).  Here the replications are one batched tensor
computation: the resampled counts are a [reps, O] matrix and the reformed
cuts of every replication come out of one product with it.

Note: reformCuts in the reference declares ``int lb`` — truncating a
non-integer lower bound.  That is a latent defect, not replicated here.
"""

from __future__ import annotations

import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import ProblemArrays, SDState
from stochasticdecomposition_torch.sampler import sample_categorical

_NEG = -1e300


def pre_test(candid_est: float, incumb_est: float, pre_epsilon: float) -> bool:
    """preTest (optimal.c:46-59): candidate height close to incumbent's."""
    if candid_est >= 0:
        return candid_est >= (1.0 - pre_epsilon) * incumb_est
    return candid_est > (1.0 + pre_epsilon) * incumb_est


def reform_cuts(pa: ProblemArrays, state: SDState, counts):
    """reformCuts (optimal.c:187-236) for every cut under every row of
    resampled observation counts [R, O]; returns (alpha [R, K],
    beta [R, K, n1]).  The plain path's; random cost coefficients take
    core/randcost.py's variant."""
    K, O = state.cut_istar.shape
    n1 = pa.c1.shape[0]
    dtype, dev = pa.c1.dtype, pa.c1.device
    kf = float(state.k)
    R = counts.shape[0]

    o_ids = torch.arange(O, device=dev)
    # Per-cut observation validity: only obs known when the cut was formed.
    valid = (o_ids[None, :] < state.cut_omega_cnt[:, None]).to(dtype)  # [K, O]
    cnt = counts.to(dtype)                                             # [R, O]

    istar = state.cut_istar                                            # [K, O]
    lidx_sel = state.sigma_lidx[istar]
    val = state.sigma_pib[istar] + state.delta_pib[lidx_sel, o_ids[None, :]]
    alpha = cnt @ (valid * val).T / kf                                 # [R, K]

    beta = torch.zeros((R, K, n1), dtype=dtype, device=dev)
    if pa.C_cols.shape[0]:
        piC_sel = state.sigma_piC[istar]                            # [K, O, nCc]
        beta[:, :, pa.C_cols] += torch.einsum(
            "ro,ko,koc->rkc", cnt, valid, piC_sel)
    if pa.C_cols_rand.shape[0] and pa.rv_C_rows.shape[0]:
        dpiC_sel = state.delta_piC[lidx_sel, o_ids[None, :]]        # [K, O, nCr]
        beta[:, :, pa.C_cols_rand] += torch.einsum(
            "ro,ko,koc->rkc", cnt, valid, dpiC_sel)
    beta = beta / kf

    # NONTRIVIAL lb correction for unseen observations (optimal.c:232-233).
    count = cnt @ valid.T                                              # [R, K]
    alpha = alpha + (1.0 - count / kf) * pa.lb
    return alpha, beta


def _boot_lb(pa: ProblemArrays, state: SDState, good, alpha, beta):
    """calcBootstrpLB (optimal.c:240-338): closed-form dual value of the
    reformed master QP at the stored multipliers, per replication [R]."""
    kf = float(state.k)
    bk = pa.b1 - pa.A1 @ state.incumb_x
    lam = -state.pi_first
    bk_lambda = bk @ lam

    ns = torch.clamp(state.cut_ns, min=1).to(alpha.dtype)
    theta = torch.where(good, (kf / ns) * state.pi_cuts, 0.0)          # [K]
    Vk = torch.sum(theta * (alpha - beta @ state.incumb_x), dim=1)     # [R]
    Bk_theta = torch.einsum("k,rkn->rn", theta, beta)                  # [R, n1]

    # -A'lam + dj  (optimal.c:298-303).
    At_lam = -(pa.A1.T @ lam) + state.dj_master
    q = pa.c1 - Bk_theta - At_lam                                      # [R, n1]
    return Vk + bk_lambda - torch.sum(q * q, dim=1) / state.quad_scalar / 2.0


def bootstrap_draws(state: SDState, gen: torch.Generator, reps: int):
    """The bootstrap's resampling: ``reps`` rows of k categorical draws over
    the stored observations, weighted by their counts: [reps, k]."""
    w = state.omega_w.to(torch.float64)
    w = w / torch.clamp(torch.sum(w), min=1.0)
    return sample_categorical(gen, w, reps, state.k)


def bootstrap_bounds(pa: ProblemArrays, cfg: SDConfig, state: SDState,
                     draws, reform=reform_cuts):
    """The two sides of fullTest's gap (optimal.c:69-133) for each row of
    resampling draws [reps, n] (the first k of each row are used): the best
    reformed height at the incumbent and the closed-form lower bound, both
    [reps]; None when no cut has a positive master dual.  ``reform`` is
    the path's reformCuts (core/step.py::problem_path)."""
    dtype = pa.c1.dtype
    K, O = state.cut_istar.shape
    kf = float(state.k)

    # (a) choose good cuts: positive master dual (chooseCuts:139-155).
    good = state.cut_mask & (state.pi_cuts > cfg.TOLERANCE)
    if not bool(torch.any(good)):
        return None

    # (b,c) resampled counts per replication.
    d = draws[:, :state.k]
    counts = torch.zeros((d.shape[0], O), dtype=torch.int64, device=d.device)
    counts.scatter_add_(1, d, torch.ones_like(d))
    alpha, beta = reform(pa, state, counts)

    # (e) best reformed height at the incumbent (optimal.c:100).
    ns_frac = state.cut_ns.to(dtype) / kf
    h = ns_frac * (alpha - beta @ state.incumb_x) + (1.0 - ns_frac) * pa.lb
    est = torch.amax(torch.where(good, h, _NEG), dim=1)                # [R]

    # (f) closed-form lower bound (optimal.c:110).
    return est, _boot_lb(pa, state, good, alpha, beta)


def full_test(pa: ProblemArrays, cfg: SDConfig, state: SDState,
              draws, reform=reform_cuts) -> bool:
    """fullTest (optimal.c:69-133) on given resampling draws [reps, n]
    (observation indices; the first k of each row are used)."""
    bounds = bootstrap_bounds(pa, cfg, state, draws, reform)
    if bounds is None:
        return False
    est, lb_val = bounds

    # (g) normalized gap (optimal.c:117).
    ie = state.incumb_est
    denom = torch.where(torch.abs(ie) < 1e-12, 1.0, ie)
    passes = torch.abs((est - lb_val) / denom) <= cfg.EPSILON
    frac = float(torch.mean(passes.to(pa.c1.dtype)))
    return frac >= cfg.PERCENT_PASS
