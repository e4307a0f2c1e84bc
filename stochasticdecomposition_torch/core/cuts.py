"""SD cut formation: the argmax procedure as a dense masked max-reduce.

Reference: ``computeIstar`` (stocUpdate.c:142-190) loops over bases per
observation; here the whole height table H[sigma, obs] is one tensor
expression and the per-observation argmax (the triple masked argmax, a CUDA
kernel on the card) feeds the weighted accumulation of (alpha, beta)
(SDCut, cuts.c:91-194).  Also: cut heights (cuts.c:197-227), the
dual-stability ratio (cuts.c:112-128,171-182) and cut-pool management
(addCut2Pool / reduceCuts, cuts.c:261-360,610-661).

On a state sharded over obs ranks (``SDState.shard``) each rank builds the
height table over its own observation columns and launches the kernel on
that [S, O / n_obs] block; the cut's sums over observations (alpha, beta,
the dual-stability sums, the count of observations without a vertex) are
each rank's partial sums, added over the ranks in one collective, and the
cut pool stores each rank's own columns of iStar.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stochasticdecomposition_torch.core.state import (
    ProblemArrays, SDState, obs_range,
)
from stochasticdecomposition_torch.ops.argmax import triple_masked_argmax
from stochasticdecomposition_torch.parallel.distributed import obs_sum

_NEG = -1e300


def height_table(pa: ProblemArrays, state: SDState, x):
    """H[s, o] = sigma.pib + delta.pib - (sigma.piC)'x - (delta.piC)'x
    for every stored dual vertex s and observation o of this state's
    columns, plus validity masks (the argmax kernel of computeIstar,
    stocUpdate.c:161-184)."""
    S = state.sigma_pib.shape[0]
    lo, hi, _ = obs_range(state)
    dev = x.device
    if pa.C_cols.shape[0]:
        piCbarX = state.sigma_piC @ x[pa.C_cols]
    else:
        piCbarX = torch.zeros_like(state.sigma_pib)
    H = (state.sigma_pib - piCbarX)[:, None] + \
        state.delta_pib[state.sigma_lidx]                         # [S, O]
    if pa.C_cols_rand.shape[0] and pa.rv_C_rows.shape[0]:
        H = H - state.delta_piC[state.sigma_lidx] @ x[pa.C_cols_rand]
    s_valid = (torch.arange(S, device=dev) < state.sigma_cnt) & \
        state.sigma_feas                                          # feasFlag
    o_valid = torch.arange(lo, hi, device=dev) < state.omega_cnt
    return H, s_valid, o_valid


class CutParts(NamedTuple):
    alpha: torch.Tensor       # scalar
    beta: torch.Tensor        # [n1]
    istar: torch.Tensor       # [O] int64 (this state's columns)
    height: torch.Tensor      # [O] argmax height per observation
    found: bool               # every active obs had a valid vertex


def accumulate(pa: ProblemArrays, state: SDState, istar, o_valid, k: int):
    """Weighted (alpha, beta) sums over this state's observations
    (cuts.c:160-168,184-188)."""
    n1 = pa.c1.shape[0]
    dtype = state.sigma_pib.dtype
    w = torch.where(o_valid, state.omega_w, 0).to(dtype)

    lidx_sel = state.sigma_lidx[istar]                            # [O]
    o_ids = torch.arange(istar.shape[0], device=istar.device)
    dpib_sel = state.delta_pib[lidx_sel, o_ids]                   # [O]
    alpha = torch.sum(w * (state.sigma_pib[istar] + dpib_sel)) / k

    beta = torch.zeros(n1, dtype=dtype, device=istar.device)
    if pa.C_cols.shape[0]:
        piC_sel = state.sigma_piC[istar]                          # [O, nCc]
        beta = beta.index_add(0, pa.C_cols,
                              torch.sum(w[:, None] * piC_sel, dim=0))
    if pa.C_cols_rand.shape[0] and pa.rv_C_rows.shape[0]:
        dpiC_sel = state.delta_piC[lidx_sel, o_ids]               # [O, nCr]
        beta = beta.index_add(0, pa.C_cols_rand,
                              torch.sum(w[:, None] * dpiC_sel, dim=0))
    return alpha, beta / k


def cut_argmax(pa: ProblemArrays, state: SDState, x, ns_eff: int):
    """computeIstar's three masked argmaxes over the sigma pool at x
    (cuts.c:147-157) in one pass of the CUDA kernel: all valid vertices,
    the "old" ones (found at ``ck <= ns_eff``) and the "new" ones.
    Returns (i_all, h_all, i_old, h_old, i_new, h_new, o_valid), each [O];
    with dual stability off the old/new outputs are simply unused."""
    H, s_valid, o_valid = height_table(pa, state, x)
    om1 = s_valid & (state.sigma_ck <= ns_eff)
    nm1 = s_valid & (state.sigma_ck > ns_eff)
    return (*triple_masked_argmax(H, s_valid, om1, nm1), o_valid)


def form_cut(pa: ProblemArrays, state: SDState, x, k: int, *,
             dual_stability: bool, pi_eval_start: int, pi_cycle: int,
             scan_len: int, batch: int = 1, argmax=cut_argmax,
             accumulate=accumulate):
    """SDCut (cuts.c:91-194): argmax over the vertex pool for every
    observation, weighted cut coefficients, and the dual-stability update.
    ``k`` counts samples; with ``batch`` samples per step the ratio window
    holds one entry per step and ``scan_len`` counts steps
    (``SDConfig.eff_scan_len``).  Returns (CutParts, state) — state carries
    the pi_ratio/dual_stable update.

    ``argmax`` and ``accumulate`` are the plain path's; random cost
    coefficients pass core/randcost.py's, whose pool axis is the basis
    pool and whose heights carry the cost multipliers (the JAX package's
    core/cuts.py:123-136)."""
    dtype = state.sigma_pib.dtype
    # 10% holdout split (computeIstar:147-157): "old" vertices were found
    # at ck <= k - (0.1k + 1); "new" ones after.
    ns_eff = k - math.floor(0.1 * float(k) + 1)
    i_all, h_all, i_old, h_old, i_new, h_new, o_valid = argmax(
        pa, state, x, ns_eff)

    # The sums over observations first, in one collective when sharded.
    sums = []
    if dual_stability:
        # pi_eval gate (cuts.c:112-113): every PI_CYCLE iters past the start.
        pi_eval = k > pi_eval_start and (pi_cycle <= 1 or k % pi_cycle == 0)
        if pi_eval:
            use_new = h_new > h_old
            istar = torch.where(use_new, i_new, i_old)
            hstar = torch.maximum(h_old, h_new)
        else:
            istar, hstar = i_all, h_all
        h_split = torch.maximum(h_old, h_new)

        w = torch.where(o_valid, state.omega_w, 0).to(dtype)
        sums = [torch.sum(w * torch.clamp(h_old - pa.lb, min=0.0)),
                torch.sum(w * torch.clamp(h_split - pa.lb, min=0.0))]
    else:
        istar, hstar = i_all, h_all
    alpha, beta = accumulate(pa, state, istar, o_valid, k)
    missing = torch.sum(o_valid & ~(hstar > _NEG / 2))
    if state.shard is not None:
        total = obs_sum(torch.cat([alpha[None], beta, *(v[None] for v in sums),
                                   missing[None].to(dtype)]), state.shard)
        n1 = beta.shape[0]
        alpha, beta, missing = total[0], total[1:1 + n1], total[-1]
        sums = list(total[1 + n1:-1])
    found = bool(missing == 0)

    if dual_stability:
        cumm_old, cumm_all = sums
        ratio = torch.where(cumm_all == 0.0, 1.0,
                            cumm_old / torch.where(cumm_all == 0.0, 1.0,
                                                   cumm_all))
        # Rolling window indexed by the step k // batch, as the reference's
        # pi_ratio[numSamples % SCAN_LEN] (cuts.c:172): the candidate and
        # incumbent cuts of one step share a slot.
        if pi_eval:
            state.pi_ratio[(k // batch) % scan_len] = ratio
            state = state._replace(ratio_cnt=state.ratio_cnt + 1)
            # Variance over the window (calcVariance, cuts.c:366-396), only
            # meaningful once the window has wrapped (cuts.c:173-176); the
            # gate counts samples.
            if (k - pi_eval_start) > scan_len * batch:
                window = state.pi_ratio[:scan_len]
                variance = float(torch.var(window, correction=0)) * \
                    scan_len / (scan_len - 1)
            else:
                variance = 1.0
            stable = not (abs(variance) >= 2e-6 or float(ratio) < 0.95)
            state = state._replace(dual_stable=stable)

    return CutParts(alpha=alpha, beta=beta, istar=istar, height=hstar,
                    found=found), state


def cut_heights_at(pa: ProblemArrays, state: SDState, x, k: int):
    """Height of every pooled cut at x with the sample-size discounting
    (cutHeight, cuts.c:213-227):  (j/k)(alpha - beta'x) + (1 - j/k) lb."""
    t_over_k = state.cut_ns.to(state.cut_alpha.dtype) / k
    raw = state.cut_alpha - state.cut_beta @ x
    return t_over_k * raw + (1.0 - t_over_k) * pa.lb


def max_cut_height(pa: ProblemArrays, state: SDState, x, k: int):
    """maxCutHeight (cuts.c:197-209) over active cut slots; with no active
    cut the approximation of E[h] is its lower bound (setup.c:102)."""
    h = cut_heights_at(pa, state, x, k)
    any_cut = torch.any(state.cut_mask)
    best = torch.amax(torch.where(state.cut_mask, h, _NEG))
    return torch.where(any_cut, best, pa.lb)


def add_cut(pa: ProblemArrays, state: SDState, parts: CutParts, k: int, *,
            incumbent: bool, tol: float):
    """addCut2Pool (cuts.c:616-661) + reduceCuts eviction (cuts.c:277-320).

    Slot discipline: free slot if available; otherwise CANDIDATE cuts evict
    the oldest slack non-incumbent cut (else the lowest non-incumbent cut at
    candidX), INCUMBENT cuts replace the old incumbent slot.  A cut whose
    argmax found no valid vertex for some observation (the istar < 0 error
    of cuts.c:136-139) is not stored and ``cut_ok`` records the skip.
    Returns (state, slot)."""
    K = state.cut_mask.shape[0]
    dev = state.cut_mask.device
    if not parts.found:
        return state._replace(cut_ok=False), state.i_cut_idx
    n_used = int(torch.sum(state.cut_mask))
    if n_used < K:
        slot = int(torch.argmin(state.cut_mask.to(torch.int8)))  # first free
    elif incumbent:
        slot = state.i_cut_idx
    else:
        is_inc_slot = torch.arange(K, device=dev) == state.i_cut_idx
        # Oldest (min numSamples) slack cut: |pi| <= tol, not incumbent.
        slack = (torch.abs(state.pi_cuts) <= tol) & state.cut_mask & \
            ~is_inc_slot
        if bool(torch.any(slack)):
            ns_key = torch.where(slack, state.cut_ns, 2 ** 30)
            slot = int(torch.argmin(ns_key))
        else:
            # Fallback: min height at candidX among non-incumbent cuts.
            h = cut_heights_at(pa, state, state.candid_x, k)
            h_key = torch.where(state.cut_mask & ~is_inc_slot, h, math.inf)
            slot = int(torch.argmin(h_key))

    state.cut_alpha[slot] = parts.alpha
    state.cut_beta[slot] = parts.beta
    state.cut_ns[slot] = k
    state.cut_omega_cnt[slot] = state.omega_cnt
    state.cut_istar[slot] = parts.istar
    state.cut_mask[slot] = True
    state.pi_cuts[slot] = 0.0
    if incumbent:
        state = state._replace(i_cut_idx=slot, i_cut_updt=k)
    return state, slot
