"""Optimality tests: pre-test and the bootstrap full test.

Reference: optimal.c.  The full test (optimal.c:69-133) resamples the
empirical distribution BOOTSTRAP_REP times, reforms the "good" cuts from the
stored iStar indices (reformCuts, optimal.c:187-236), and compares the upper
estimate against the closed-form QP dual lower bound (calcBootstrpLB,
optimal.c:240-338).  Here the replications are one batched tensor
computation: the resampled counts are a [reps, O] matrix and the reformed
cuts of every replication come out of one product with it.

On a state sharded over obs ranks (``SDState.shard``) the resampling is
drawn alike on every rank from the global weights, each rank counts the
draws that fall in its own observation columns and reforms the cuts over
them, and the three things the test reads, all linear in the counts — the
reformed alpha [R, K], beta at the incumbent [R, K] and the master-dual
weighted beta [R, n1] — are summed over the ranks in one collective.

Note: reformCuts in the reference declares ``int lb`` — truncating a
non-integer lower bound.  That is a latent defect, not replicated here.
"""

from __future__ import annotations

import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import (
    ProblemArrays, SDState, obs_range,
)
from stochasticdecomposition_torch.parallel.distributed import obs_sum
from stochasticdecomposition_torch.sampler import sample_categorical

_NEG = -1e300


def pre_test(candid_est: float, incumb_est: float, pre_epsilon: float) -> bool:
    """preTest (optimal.c:46-59): candidate height close to incumbent's."""
    if candid_est >= 0:
        return candid_est >= (1.0 - pre_epsilon) * incumb_est
    return candid_est > (1.0 + pre_epsilon) * incumb_est


def reform_sums(pa: ProblemArrays, state: SDState, counts):
    """reformCuts (optimal.c:187-236) for every cut under every row of
    resampled observation counts [R, O] of this state's observations,
    before the lb correction, which needs the counts of every rank
    (``with_lb``): (alpha [R, K], beta [R, K, n1], the counted
    observations known to each cut [R, K]).  The plain path's; random
    cost coefficients take core/randcost.py's variant."""
    K, O = state.cut_istar.shape
    n1 = pa.c1.shape[0]
    dtype, dev = pa.c1.dtype, pa.c1.device
    kf = float(state.k)
    R = counts.shape[0]
    lo, hi, _ = obs_range(state)

    o_ids = torch.arange(O, device=dev)
    # Per-cut observation validity: only obs known when the cut was formed.
    valid = ((lo + o_ids)[None, :] <
             state.cut_omega_cnt[:, None]).to(dtype)                   # [K, O]
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
    return alpha, beta / kf, cnt @ valid.T


def with_lb(pa: ProblemArrays, state: SDState, alpha, count):
    """reformCuts' NONTRIVIAL lb correction for unseen observations
    (optimal.c:232-233)."""
    return alpha + (1.0 - count / float(state.k)) * pa.lb




def _theta(state: SDState, good):
    """The good cuts' master duals scaled to the sample size [K]."""
    ns = torch.clamp(state.cut_ns, min=1).to(state.pi_cuts.dtype)
    return torch.where(good, (float(state.k) / ns) * state.pi_cuts, 0.0)


def _boot_lb(pa: ProblemArrays, state: SDState, theta, alpha, beta_x,
             beta_theta):
    """calcBootstrpLB (optimal.c:240-338): closed-form dual value of the
    reformed master QP at the stored multipliers, per replication [R];
    ``beta_x`` [R, K] is beta at the incumbent, ``beta_theta`` [R, n1] the
    theta-weighted beta."""
    bk = pa.b1 - pa.A1 @ state.incumb_x
    lam = -state.pi_first
    bk_lambda = bk @ lam

    Vk = torch.sum(theta * (alpha - beta_x), dim=1)                    # [R]

    # -A'lam + dj  (optimal.c:298-303).
    At_lam = -(pa.A1.T @ lam) + state.dj_master
    q = pa.c1 - beta_theta - At_lam                                    # [R, n1]
    return Vk + bk_lambda - torch.sum(q * q, dim=1) / state.quad_scalar / 2.0


def bootstrap_draws(state: SDState, gen: torch.Generator, reps: int):
    """The bootstrap's resampling: ``reps`` rows of k categorical draws over
    the stored observations, weighted by their counts: [reps, k] global
    indices, the same on every obs rank of a sharded state."""
    w = state.omega_w.to(torch.float64)
    if state.shard is not None:
        lo, hi, O = obs_range(state)
        w = obs_sum(torch.nn.functional.pad(w, (lo, O - hi)), state.shard)
    w = w / torch.clamp(torch.sum(w), min=1.0)
    return sample_categorical(gen, w, reps, state.k)


def bootstrap_bounds(pa: ProblemArrays, cfg: SDConfig, state: SDState,
                     draws, reform=reform_sums):
    """The two sides of fullTest's gap (optimal.c:69-133) for each row of
    resampling draws [reps, n] (the first k of each row are used): the best
    reformed height at the incumbent and the closed-form lower bound, both
    [reps]; None when no cut has a positive master dual.  ``reform`` is
    the path's reformCuts sums (core/step.py::problem_path)."""
    dtype = pa.c1.dtype
    kf = float(state.k)
    lo, hi, _ = obs_range(state)

    # (a) choose good cuts: positive master dual (chooseCuts:139-155).
    good = state.cut_mask & (state.pi_cuts > cfg.TOLERANCE)
    if not bool(torch.any(good)):
        return None
    theta = _theta(state, good)

    # (b,c) resampled counts per replication, of this state's columns.
    d = draws[:, :state.k]
    mine = (d >= lo) & (d < hi)
    counts = torch.zeros((d.shape[0], hi - lo), dtype=torch.int64,
                         device=d.device)
    counts.scatter_add_(1, torch.where(mine, d - lo, 0), mine.long())
    alpha, beta, count = reform(pa, state, counts)
    R, K = alpha.shape
    total = obs_sum(torch.cat([
        alpha.reshape(-1), count.reshape(-1),
        (beta @ state.incumb_x).reshape(-1),
        torch.einsum("k,rkn->rn", theta, beta).reshape(-1)]), state.shard)
    alpha, count, beta_x = total[:3 * R * K].reshape(3, R, K)
    beta_theta = total[3 * R * K:].reshape(R, -1)
    alpha = with_lb(pa, state, alpha, count)

    # (e) best reformed height at the incumbent (optimal.c:100).
    ns_frac = state.cut_ns.to(dtype) / kf
    h = ns_frac * (alpha - beta_x) + (1.0 - ns_frac) * pa.lb
    est = torch.amax(torch.where(good, h, _NEG), dim=1)                # [R]

    # (f) closed-form lower bound (optimal.c:110).
    return est, _boot_lb(pa, state, theta, alpha, beta_x, beta_theta)


def full_test(pa: ProblemArrays, cfg: SDConfig, state: SDState,
              draws, reform=reform_sums) -> bool:
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
