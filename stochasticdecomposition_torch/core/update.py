"""Stochastic updates: the incremental omega/lambda/sigma/delta machinery.

Reference: stocUpdate.c.  Dedup scans (equalVector with TOLERANCE at
stocUpdate.c:272,300-308,331) are masked all-pairs compares over the fixed
capacity pools, as in the JAX package; the outcome of each dedup (found or
new) is read back to the host, which then writes the new pool entry in
place.  The delta table fills (stocUpdate.c:196-257) are matrix products.
"""

from __future__ import annotations

import torch

from stochasticdecomposition_torch.core.state import ProblemArrays, SDState
from stochasticdecomposition_torch.ops.simplex import (
    AT_LOWER, AT_UPPER, STATUS_OPTIMAL, LPResult, lane, solve_lp,
)


def subproblem_rhs_cost(pa: ProblemArrays, x, w):
    """rhs = (bBar + b_w) - (CBar + C_w) x and cost = dBar + d_w for one
    centered observation w (reference computeRHS/computeCostCoeff,
    subprob.c:96-156)."""
    nb = pa.rv_b_rows.shape[0]
    nC = pa.rv_C_rows.shape[0]
    nd = pa.rv_d_cols.shape[0]
    off_C = nb
    off_d = nb + nC

    rhs = pa.b_bar - pa.C_bar @ x
    if nb:
        rhs = rhs.index_add(0, pa.rv_b_rows, w[:nb])
    if nC:
        contrib = w[off_C:off_C + nC] * x[pa.rv_C_cols]
        rhs = rhs.index_add(0, pa.rv_C_rows, -contrib)
    cost = pa.d_bar
    if nd:
        cost = cost.index_add(0, pa.rv_d_cols, w[off_d:off_d + nd])
    return rhs, cost


def solve_subproblem(pa: ProblemArrays, x, w, *, max_iter: int = 0,
                     init_basis=None, init_at_upper=None) -> LPResult:
    """One subproblem LP solve (subprob.c:17-84 without the updates); the
    result is one lane's (no lane axis)."""
    rhs, cost = subproblem_rhs_cost(pa, x, w)
    res = solve_lp(
        pa.D, pa.sense2, cost[None], pa.l2, pa.u2, rhs[None],
        max_iter=max_iter,
        init_basis=None if init_basis is None else init_basis[None],
        init_at_upper=None if init_at_upper is None else init_at_upper[None])
    return lane(res, 0)


def warm_solve_subproblem(pa: ProblemArrays, state: SDState, x, w):
    """Subproblem solve warm-started from the previous optimal basis carried
    in the state; returns (res, state) with the warm basis refreshed when
    the solve was optimal (the reference's CPLEX problem object keeps its
    basis between solves for the same effect, subprob.c:43-45)."""
    res = solve_subproblem(pa, x, w, init_basis=state.warm_basis,
                           init_at_upper=state.warm_atup)
    ok = res.status == STATUS_OPTIMAL
    atup = torch.cat([res.cstat, res.rstat]) == AT_UPPER
    state = state._replace(
        warm_basis=torch.where(ok, res.basis, state.warm_basis),
        warm_atup=torch.where(ok, atup, state.warm_atup))
    return res, state


def compute_mu(res: LPResult):
    """mubBar: bound-dual correction (computeMU, stocUpdate.c:351-387)."""
    at_bound = (res.cstat == AT_LOWER) | (res.cstat == AT_UPPER)
    return torch.sum(torch.where(at_bound, res.dj * res.y, 0.0))


def _first_match(close: torch.Tensor, cnt: int):
    """Index of the first True among the first ``cnt`` entries, or None."""
    hits = torch.nonzero(close[:cnt])
    return int(hits[0, 0]) if hits.shape[0] else None


def calc_omega(state: SDState, w, tol: float):
    """Dedup the new observation into the omega pool (stocUpdate.c:326-348).

    Returns (state, idx, is_new)."""
    cnt = state.omega_cnt
    if w.shape[0]:
        close = torch.all(torch.abs(state.omega_vals - w[None, :]) <= tol,
                          dim=1)
    else:
        close = torch.ones(state.omega_vals.shape[0], dtype=torch.bool,
                           device=w.device)
    found = _first_match(close, cnt)
    if found is None:
        idx = cnt
        if idx < state.omega_vals.shape[0]:
            state.omega_vals[idx] = w
        cnt += 1
    else:
        idx = found
    if idx < state.omega_w.shape[0]:
        state.omega_w[idx] += 1
    return state._replace(omega_cnt=cnt), idx, found is None


def delta_new_omega_column(pa: ProblemArrays, state: SDState, o_idx: int):
    """Fill delta column o_idx for every stored lambda (calcDelta Case I,
    stocUpdate.c:206-229).  Unused lambda rows are zero so no mask needed."""
    nb = pa.rv_b_rows.shape[0]
    nC = pa.rv_C_rows.shape[0]
    w = state.omega_vals[o_idx]

    if nb:
        wb = pa.bmap @ w[:nb]                           # [nlr]
        state.delta_pib[:, o_idx] = state.lambda_vals @ wb
    else:
        state.delta_pib[:, o_idx] = 0.0
    if nC:
        wc = w[nb:nb + nC]                              # [nC]
        lamC = state.lambda_vals[:, pa.lam_pos_C]       # [L, nC]
        state.delta_piC[:, o_idx, :] = (lamC * wc[None, :]) @ pa.Cgroup
    return state


def delta_new_lambda_row(pa: ProblemArrays, state: SDState, l_idx: int):
    """Fill delta row l_idx for every stored omega (calcDelta Case II,
    stocUpdate.c:230-254).  Unused omega columns are zero-vectors -> zeros."""
    nb = pa.rv_b_rows.shape[0]
    nC = pa.rv_C_rows.shape[0]
    lam = state.lambda_vals[l_idx]

    if nb:
        state.delta_pib[l_idx, :] = state.omega_vals[:, :nb] @ (pa.bmap.T @ lam)
    else:
        state.delta_pib[l_idx, :] = 0.0
    if nC:
        lamk = lam[pa.lam_pos_C]                        # [nC]
        state.delta_piC[l_idx, :, :] = (
            state.omega_vals[:, nb:nb + nC] * lamk[None, :]) @ pa.Cgroup
    return state


def calc_lambda(pa: ProblemArrays, state: SDState, pi, tol: float):
    """Dedup the dual sub-vector on random rows (calcLambda,
    stocUpdate.c:264-284).  Returns (state, lidx, is_new)."""
    lam = pi[pa.lambda_rows]
    L = state.lambda_vals.shape[0]
    cnt = state.lambda_cnt
    if lam.shape[0]:
        close = torch.all(torch.abs(state.lambda_vals - lam[None, :]) <= tol,
                          dim=1)
    else:
        close = torch.ones(L, dtype=torch.bool, device=pi.device)
    found = _first_match(close, cnt)
    if found is not None:
        return state, found, False
    idx = cnt
    state = state._replace(lambda_cnt=cnt + 1)
    if idx < L:
        state.lambda_vals[idx] = lam
        # New lambda -> fill its delta row against all observations.
        state = delta_new_lambda_row(pa, state, idx)
    return state, idx, True


def calc_sigma(pa: ProblemArrays, state: SDState, pi, mub_bar, lidx: int,
               new_lambda: bool, feas: bool, k: int, tol: float):
    """Dedup (pib, piC, lambdaIdx) into sigma (calcSigma,
    stocUpdate.c:286-320).  Returns (state, sidx, is_new)."""
    pib = pi @ pa.b_bar + mub_bar
    piC = (pi @ pa.C_bar)[pa.C_cols]

    S = state.sigma_pib.shape[0]
    cnt = state.sigma_cnt
    found = None
    if not new_lambda:
        close = (torch.abs(state.sigma_pib - pib) <= tol) & \
            (state.sigma_lidx == lidx)
        if piC.shape[0]:
            close &= torch.all(
                torch.abs(state.sigma_piC - piC[None, :]) <= tol, dim=1)
        found = _first_match(close, cnt)
    if found is not None:
        return state, found, False
    idx = cnt
    if idx < S:
        state.sigma_pib[idx] = pib
        state.sigma_piC[idx] = piC
        state.sigma_lidx[idx] = lidx
        state.sigma_ck[idx] = k
        state.sigma_feas[idx] = feas
    return state._replace(sigma_cnt=cnt + 1), idx, True


def stochastic_updates(pa: ProblemArrays, state: SDState, res: LPResult,
                       o_idx: int, new_o: bool, k: int, tol: float):
    """Full update pass for one subproblem dual (stochasticUpdates,
    stocUpdate.c:14-133) on the plain-randomness path.
    Returns (state, sigma_idx)."""
    if int(pa.rv_d_cols.shape[0]) > 0:
        raise NotImplementedError(
            "random cost coefficients (the v2.0 basis machinery) are not "
            "ported yet")

    # New observation -> new delta column against all lambdas (must run before
    # the new lambda row fill, mirroring stocUpdate.c:24-31).
    if new_o and o_idx < state.delta_pib.shape[1]:
        state = delta_new_omega_column(pa, state, o_idx)

    feas = bool(res.status == STATUS_OPTIMAL)
    # For infeasible subproblems the dual ray (Farkas certificate) enters the
    # pools with feasFlag=false (stocUpdate.c:66-75).
    if feas:
        pi, mub = res.pi, compute_mu(res)
    else:
        # Ray bound correction: the feasibility cut's constant absorbs
        # -sup_{l<=y<=u} ray'Dy (the ray analog of computeMU's mubBar).
        pi = res.farkas
        rd = res.farkas @ pa.D
        u_fin = torch.where(torch.isfinite(pa.u2), pa.u2, 0.0)
        l_fin = torch.where(torch.isfinite(pa.l2), pa.l2, 0.0)
        mub = -torch.sum(u_fin * torch.clamp(rd, min=0.0) +
                         l_fin * torch.clamp(rd, max=0.0))

    state, lidx, new_lam = calc_lambda(pa, state, pi, tol)
    state, sidx, _ = calc_sigma(pa, state, pi, mub, lidx, new_lam, feas, k,
                                tol)
    return state, sidx
