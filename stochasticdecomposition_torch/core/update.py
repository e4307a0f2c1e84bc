"""Stochastic updates: the incremental omega/lambda/sigma/delta machinery.

Reference: stocUpdate.c.  Dedup scans (equalVector with TOLERANCE at
stocUpdate.c:272,300-308,331) are masked all-pairs compares over the fixed
capacity pools, as in the JAX package; the outcome of each dedup (found or
new) is read back to the host, which then writes the new pool entry in
place.  The delta table fills (stocUpdate.c:196-257) are matrix products.

On a state sharded over obs ranks (``SDState.shard``) every rank holds its
block [lo, hi) of the observation columns: the omega dedup takes the
minimum over the ranks of each rank's first match, a new observation is
stored (and weighted) by the rank that owns its index, and the delta fills
cover the rank's own columns; the lambda and sigma pools are replicated.
"""

from __future__ import annotations

import numpy as np
import torch

from stochasticdecomposition_torch.core.state import (
    ProblemArrays, SDState, obs_range,
)
from stochasticdecomposition_torch.ops.simplex import (
    AT_LOWER, AT_UPPER, STATUS_OPTIMAL, LPResult, lane, solve_lp,
)
from stochasticdecomposition_torch.parallel.distributed import (
    obs_min, obs_sum,
)

_NO_MATCH = 2 ** 62             # above every observation index


def subproblem_rhs_cost(pa: ProblemArrays, x, w):
    """rhs = (bBar + b_w) - (CBar + C_w) x and cost = dBar + d_w for one
    centered observation w (reference computeRHS/computeCostCoeff,
    subprob.c:96-156)."""
    rhs, cost = subproblem_rhs_cost_lanes(pa, x, w[None])
    return rhs[0], cost[0]


def subproblem_rhs_cost_lanes(pa: ProblemArrays, x, W):
    """``subproblem_rhs_cost`` for the rows of W [B, R] at one x:
    (rhs [B, m2], cost [B, n2])."""
    nb = pa.rv_b_rows.shape[0]
    nC = pa.rv_C_rows.shape[0]
    nd = pa.rv_d_cols.shape[0]
    off_C = nb
    off_d = nb + nC
    B = W.shape[0]

    rhs = (pa.b_bar - pa.C_bar @ x).expand(B, -1)
    if nb:
        rhs = rhs.index_add(1, pa.rv_b_rows, W[:, :nb])
    if nC:
        contrib = W[:, off_C:off_C + nC] * x[pa.rv_C_cols]
        rhs = rhs.index_add(1, pa.rv_C_rows, -contrib)
    cost = pa.d_bar.expand(B, -1)
    if nd:
        cost = cost.index_add(1, pa.rv_d_cols, W[:, off_d:off_d + nd])
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


def ray_mub(pa: ProblemArrays, farkas):
    """The Farkas ray's bound correction, -sup_{l<=y<=u} ray'Dy: the
    feasibility cut's constant absorbs it (the ray analog of computeMU's
    mubBar).  ``farkas`` [m2] or [B, m2]."""
    rd = farkas @ pa.D
    u_fin = torch.where(torch.isfinite(pa.u2), pa.u2, 0.0)
    l_fin = torch.where(torch.isfinite(pa.l2), pa.l2, 0.0)
    return -torch.sum(u_fin * torch.clamp(rd, min=0.0) +
                      l_fin * torch.clamp(rd, max=0.0), dim=-1)


def _first_match(close: torch.Tensor, cnt: int):
    """Index of the first True among the first ``cnt`` entries, or None."""
    hits = torch.nonzero(close[:cnt])
    return int(hits[0, 0]) if hits.shape[0] else None


def calc_omega(state: SDState, w, tol: float):
    """Dedup the new observation into the omega pool (stocUpdate.c:326-348).

    Returns (state, idx, is_new); ``idx`` is the global index."""
    cnt = state.omega_cnt
    lo, hi, _ = obs_range(state)
    if w.shape[0]:
        close = torch.all(torch.abs(state.omega_vals - w[None, :]) <= tol,
                          dim=1)
    else:
        close = torch.ones(state.omega_vals.shape[0], dtype=torch.bool,
                           device=w.device)
    found = _first_match(close, max(cnt - lo, 0))
    if state.shard is not None:
        first = torch.tensor([_NO_MATCH if found is None else lo + found])
        first = int(obs_min(first, state.shard))
        found = None if first == _NO_MATCH else first - lo
    if found is None:
        idx = cnt
        if lo <= idx < hi:
            state.omega_vals[idx - lo] = w
        cnt += 1
    else:
        idx = lo + found
    if lo <= idx < hi:
        state.omega_w[idx - lo] += 1
    return state._replace(omega_cnt=cnt), idx, found is None


def omega_rows(state: SDState, idx) -> torch.Tensor:
    """The stored observations at the global indices ``idx`` (int64 [B]
    on the state's device): [B, R] on every rank, each row from the rank
    that owns it."""
    if state.shard is None:
        return state.omega_vals[idx]
    lo, hi, _ = obs_range(state)
    mine = (idx >= lo) & (idx < hi)
    rows = torch.zeros((idx.shape[0], state.omega_vals.shape[1]),
                       dtype=state.omega_vals.dtype, device=idx.device)
    rows[mine] = state.omega_vals[idx[mine] - lo]
    return obs_sum(rows, state.shard)


def omega_row(state: SDState, o_idx: int) -> torch.Tensor:
    """The stored observation ``o_idx`` (global) on every rank."""
    if state.shard is None:
        return state.omega_vals[o_idx]
    idx = torch.tensor([o_idx], device=state.omega_vals.device)
    return omega_rows(state, idx)[0]


def delta_new_omega_column(pa: ProblemArrays, state: SDState, o_idx: int):
    """Fill delta column o_idx (of this state's columns) for every stored
    lambda (calcDelta Case I, stocUpdate.c:206-229).  Unused lambda rows
    are zero so no mask needed."""
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
    """Fill delta row l_idx for every stored omega of this state's columns
    (calcDelta Case II, stocUpdate.c:230-254).  Unused omega columns are
    zero-vectors -> zeros."""
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


def _batch_dedup(cand, pool, cnt0: int, tol: float, extra_eq=None,
                 shard=None, offset: int = 0):
    """Order-preserving dedup of a candidate batch against a pool: the
    outcome of B sequential per-item dedups, in one pass.

    Item i matches the pool, or an earlier batch item j < i that was itself
    added as new (an item that matched the pool is never added, so a
    near-match to it does not count: the tolerance chaining of the
    sequential scan).  cand: [B, d]; pool: [cnt0, d], the occupied rows;
    ``extra_eq``: optional ([B, cnt0], [B, B]) equality masks ANDed in.
    With ``shard``, ``pool`` is this rank's block of the pool, which starts
    at index ``offset``, and the first pool match is the minimum over the
    obs ranks.  Returns (idx int64 [B] on the host, is_new bool [B] on the
    host, new_cnt); new items take consecutive slots from cnt0 in batch
    order.
    """
    B, d = cand.shape
    if d:
        close_pool = torch.all(
            torch.abs(cand[:, None, :] - pool[None, :, :]) <= tol, dim=2)
        close_batch = torch.all(
            torch.abs(cand[:, None, :] - cand[None, :, :]) <= tol, dim=2)
    else:
        close_pool = torch.ones((B, pool.shape[0]), dtype=torch.bool,
                                device=cand.device)
        close_batch = torch.ones((B, B), dtype=torch.bool, device=cand.device)
    if extra_eq is not None:
        close_pool = close_pool & extra_eq[0]
        close_batch = close_batch & extra_eq[1]
    match_pool = torch.any(close_pool, dim=1)
    first_pool = torch.argmax(close_pool.to(torch.int8), dim=1) \
        if close_pool.shape[1] else torch.zeros(B, dtype=torch.int64,
                                                device=cand.device)
    if shard is not None:
        first_pool = obs_min(torch.where(match_pool, first_pool + offset,
                                         _NO_MATCH), shard)
        match_pool = first_pool < _NO_MATCH
    # One transfer: the sequential decisions are B steps on the host.
    match_pool, first_pool, close_batch = (
        t.cpu().numpy() for t in (match_pool, first_pool, close_batch))
    idx = np.empty(B, np.int64)
    is_new = np.zeros(B, bool)
    cnt = cnt0
    for i in range(B):
        if match_pool[i]:
            idx[i] = first_pool[i]
            continue
        hits = np.flatnonzero(close_batch[i, :i] & is_new[:i])
        if hits.shape[0]:
            idx[i] = idx[hits[0]]
        else:
            is_new[i] = True
            idx[i] = cnt
            cnt += 1
    return idx, is_new, cnt


def calc_omega_batch(state: SDState, w_batch, tol: float):
    """B observations deduped into the omega pool at once: the same pool
    contents, weights and slot order as B sequential ``calc_omega`` calls
    (which the JAX package makes on random-cost problems; the outcome is
    the same on every problem).
    Returns (state, o_idxs, new_flags), both numpy [B]; the indices are
    global."""
    cnt = state.omega_cnt
    lo, hi, _ = obs_range(state)
    idx, is_new, cnt1 = _batch_dedup(
        w_batch, state.omega_vals[:max(min(cnt, hi) - lo, 0)], cnt, tol,
        shard=state.shard, offset=lo)
    mine = (idx >= lo) & (idx < hi)
    put = is_new & mine
    if put.any():
        state.omega_vals[torch.as_tensor(idx[put] - lo,
                                         device=w_batch.device)] = \
            w_batch[torch.as_tensor(np.flatnonzero(put),
                                    device=w_batch.device)]
    inside = idx[mine] - lo
    state.omega_w.index_add_(
        0, torch.as_tensor(inside, device=w_batch.device),
        torch.ones(inside.shape[0], dtype=state.omega_w.dtype,
                   device=w_batch.device))
    return state._replace(omega_cnt=cnt1), idx, is_new


def stochastic_updates_batch(pa: ProblemArrays, state: SDState,
                             res_b: LPResult, o_idxs, new_o, k: int,
                             tol: float) -> SDState:
    """Pool B subproblem duals (``res_b`` with its lane axis) on the
    plain-randomness path: the same final pools as B sequential
    ``stochastic_updates`` calls, with the dedups done batch-wise and each
    delta fill one product over the new rows or columns.

    The delta table is a function of (lambda row, omega column) alone, so
    only coverage matters: new lambda rows are filled against the extended
    omega pool, then new omega columns against the extended lambda pool
    (a (new, new) pair gets the column's value).  Random cost
    coefficients take core/randcost.py's variant instead."""
    nb = pa.rv_b_rows.shape[0]
    nC = pa.rv_C_rows.shape[0]
    dev = state.lambda_vals.device
    B = len(o_idxs)

    feas = res_b.status == STATUS_OPTIMAL                        # [B]
    pi_b = torch.where(feas[:, None], res_b.pi, res_b.farkas)    # [B, m2]
    mub_ray = ray_mub(pa, res_b.farkas)                          # [B]
    at_bound = (res_b.cstat == AT_LOWER) | (res_b.cstat == AT_UPPER)
    mu_opt = torch.sum(torch.where(at_bound, res_b.dj * res_b.y, 0.0), dim=1)
    mub = torch.where(feas, mu_opt, mub_ray)                     # [B]

    # ---- lambda dedup (calcLambda x B) ---------------------------------
    L = state.lambda_vals.shape[0]
    lam_b = pi_b[:, pa.lambda_rows]                              # [B, nlr]
    lcnt = state.lambda_cnt
    lidx, new_lam, lcnt1 = _batch_dedup(
        lam_b, state.lambda_vals[:min(lcnt, L)], lcnt, tol)
    state = state._replace(lambda_cnt=lcnt1)
    new_l = np.flatnonzero(new_lam & (lidx < L))
    rows_l = torch.as_tensor(lidx[new_l], device=dev)
    items_l = torch.as_tensor(new_l, device=dev)
    if new_l.shape[0]:
        state.lambda_vals[rows_l] = lam_b[items_l]

    # ---- delta fills (calcDelta Cases II then I), this state's columns --
    lo, hi, _ = obs_range(state)
    new_c = np.flatnonzero(new_o & (o_idxs >= lo) & (o_idxs < hi))
    cols_o = torch.as_tensor(o_idxs[new_c] - lo, device=dev)
    if nb:
        if new_l.shape[0]:
            state.delta_pib[rows_l] = (
                state.omega_vals[:, :nb] @ (pa.bmap.T @ lam_b[items_l].T)).T
        if new_c.shape[0]:
            state.delta_pib[:, cols_o] = state.lambda_vals @ (
                pa.bmap @ state.omega_vals[cols_o, :nb].T)       # [L, b]
    if nC:
        if new_l.shape[0]:
            lamC = lam_b[items_l][:, pa.lam_pos_C]               # [b, nC]
            state.delta_piC[rows_l] = torch.einsum(
                "oc,bc,cr->bor", state.omega_vals[:, nb:nb + nC], lamC,
                pa.Cgroup)                                       # [b, O, nCr]
        if new_c.shape[0]:
            state.delta_piC[:, cols_o] = torch.einsum(
                "bc,lc,cr->lbr", state.omega_vals[cols_o, nb:nb + nC],
                state.lambda_vals[:, pa.lam_pos_C], pa.Cgroup)   # [L, b, nCr]

    # ---- sigma dedup (calcSigma x B) ------------------------------------
    pib_b = pi_b @ pa.b_bar + mub                                # [B]
    piC_b = (pi_b @ pa.C_bar)[:, pa.C_cols]                      # [B, nCc]
    S = state.sigma_pib.shape[0]
    scnt = state.sigma_cnt
    sn = min(scnt, S)
    cand = torch.cat([pib_b[:, None], piC_b], dim=1)
    pool = torch.cat([state.sigma_pib[:sn, None], state.sigma_piC[:sn]],
                     dim=1)
    # A new lambda forces a new sigma entry (calcSigma's new_lambda gate):
    # pool rows never match a new-lambda item; within the batch an item
    # matches only earlier items of the same final lambda index.
    lidx_t = torch.as_tensor(lidx, device=dev)
    new_lam_t = torch.as_tensor(new_lam, device=dev)
    eq_pool = (state.sigma_lidx[None, :sn] == lidx_t[:, None]) & \
        ~new_lam_t[:, None]
    eq_batch = lidx_t[None, :] == lidx_t[:, None]
    sidx, new_sig, scnt1 = _batch_dedup(cand, pool, scnt, tol,
                                        extra_eq=(eq_pool, eq_batch))
    new_s = np.flatnonzero(new_sig & (sidx < S))
    if new_s.shape[0]:
        rows_s = torch.as_tensor(sidx[new_s], device=dev)
        items_s = torch.as_tensor(new_s, device=dev)
        state.sigma_pib[rows_s] = pib_b[items_s]
        state.sigma_piC[rows_s] = piC_b[items_s]
        state.sigma_lidx[rows_s] = lidx_t[items_s]
        state.sigma_ck[rows_s] = k
        state.sigma_feas[rows_s] = feas[items_s]
    return state._replace(sigma_cnt=scnt1)


def stochastic_updates(pa: ProblemArrays, state: SDState, res: LPResult,
                       o_idx: int, new_o: bool, k: int, tol: float):
    """Full update pass for one subproblem dual (stochasticUpdates,
    stocUpdate.c:14-133) on the plain path; random cost coefficients take
    core/randcost.py's variant instead.  Returns (state, sigma_idx)."""
    # New observation -> new delta column against all lambdas (must run before
    # the new lambda row fill, mirroring stocUpdate.c:24-31), by its owner.
    lo, hi, _ = obs_range(state)
    if new_o and lo <= o_idx < hi:
        state = delta_new_omega_column(pa, state, o_idx - lo)

    feas = bool(res.status == STATUS_OPTIMAL)
    # For infeasible subproblems the dual ray (Farkas certificate) enters the
    # pools with feasFlag=false (stocUpdate.c:66-75).
    if feas:
        return pool_dual(pa, state, res.pi, compute_mu(res), True, k, tol)
    return pool_dual(pa, state, res.farkas, ray_mub(pa, res.farkas), False,
                     k, tol)


def pool_dual(pa: ProblemArrays, state: SDState, pi, mub, feas: bool, k: int,
              tol: float):
    """Dedup a dual vertex (or ray, ``feas`` False) into the lambda and
    sigma pools (calcLambda + calcSigma).  Returns (state, sigma_idx)."""
    state, lidx, new_lam = calc_lambda(pa, state, pi, tol)
    state, sidx, _ = calc_sigma(pa, state, pi, mub, lidx, new_lam, feas, k,
                                tol)
    return state, sidx
