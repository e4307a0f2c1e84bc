"""Random-cost (v2.0) basis machinery.

Reference: randCost.c + the basis branches of stocUpdate.c.  With random
cost coefficients d(w) the subproblem dual depends on w; per discovered
basis it decomposes as  pi(w) = piDet + sum_n phi_n * w_n
(decomposeDualSolution, randCost.c:182-199), where phi_n are rows of the
basis inverse for basic columns with random costs (calcBasis,
randCost.c:19-123).  Heights, cut coefficients and reformed cuts carry
per-column multipliers (the observation's cost components), and every
(basis, observation) pair has a dual-feasibility flag
(checkBasisFeasibility, randCost.c:202-258), kept on the device as the
[B, O] table ``obs_feas``.

The port of the JAX package's ``core/randcost.py``.  As there, the phi, psi
and sigma-index slots of a basis are indexed by cost RV with a presence
mask instead of the reference's packed arrays.  The argmax over the basis
pool (``triple_argmax_randcost``) is blockwise PyTorch over the pool's live
prefix: it never materializes the [B, nd, O] gather.

On a state sharded over obs ranks (``SDState.shard``) the basis pool is
replicated work and ``obs_feas`` is sharded like the other observation
columns: rank j holds its columns [lo, hi) (``init_state`` allocates them),
checks a new basis against its own observations and a new observation
against every basis only where it owns it, and takes the argmax, the cut's
sums and reformCuts' sums over its own columns, which ``form_cut`` and
``bootstrap_bounds`` add over the ranks.  The one read of another rank's
column, dedup 2's feasibility of the current observation, and its cost
components come through the obs collectives.  (The JAX mesh keeps
``obs_feas`` replicated; a rank's columns of it are the same values.)
"""

from __future__ import annotations

import torch

from stochasticdecomposition_torch.core.cuts import height_table
from stochasticdecomposition_torch.core.state import (
    ProblemArrays, SDState, obs_range,
)
from stochasticdecomposition_torch.core.update import (
    calc_lambda, calc_sigma, compute_mu, delta_new_omega_column, omega_row,
    pool_dual, ray_mub,
)
from stochasticdecomposition_torch.parallel.distributed import obs_max
from stochasticdecomposition_torch.ops.simplex import (
    AT_UPPER, STATUS_OPTIMAL, LPResult, lane,
)

_NEG = -1e300


def _cost_cols(pa: ProblemArrays) -> slice:
    """The cost (d-block) components' columns of an observation."""
    off = pa.rv_b_rows.shape[0] + pa.rv_C_rows.shape[0]
    return slice(off, off + pa.rv_d_cols.shape[0])


def _wd(pa: ProblemArrays, state: SDState):
    """Cost (d-block) components of every stored observation of this
    state's columns: [O, nd]."""
    return state.omega_vals[:, _cost_cols(pa)]


def check_bases_obs(pa: ProblemArrays, phi, present, pidet, gbar, psi, cstat,
                    wd, tol: float):
    """checkBasisFeasibility (randCost.c:202-258) for bases [nb, ...] (phi
    [nb, nd, m2], present [nb, nd], pidet [nb, m2], gbar [nb, n2], psi
    [nb, nd, n2], cstat [nb, n2]) at observations ``wd`` [no, nd]:
    [nb, no] bool."""
    wdm = torch.where(present[:, None, :], wd[None], 0.0)       # [nb, no, nd]
    pi_o = pidet[:, None, :] + torch.einsum("bon,bnm->bom", wdm, phi)
    row_bad = ((pi_o < -tol) & (pa.sense2 == 1)) | \
        ((pi_o > tol) & (pa.sense2 == -1))
    d_w = torch.zeros((wd.shape[0], gbar.shape[1]), dtype=wd.dtype,
                      device=wd.device).index_add(1, pa.rv_d_cols, wd)
    rc = (gbar[:, None, :] + d_w[None]) - \
        torch.einsum("bon,bnj->boj", wdm, psi)
    col_bad = (rc < -tol) & (cstat[:, None, :] != AT_UPPER)
    return ~torch.any(row_bad, dim=2) & ~torch.any(col_bad, dim=2)


def refresh_obs_feas_new_omega(pa: ProblemArrays, state: SDState, o_idx: int,
                               tol: float) -> SDState:
    """A new observation, column ``o_idx`` of this state's columns: check
    every stored basis against it, on the device (stocUpdate.c:27-31)."""
    wd_o = _wd(pa, state)[o_idx][None]
    state.obs_feas[:, o_idx] = check_bases_obs(
        pa, state.basis_phi, state.basis_present, state.basis_pidet,
        state.basis_gbar, state.basis_psi, state.basis_cstat, wd_o, tol)[:, 0]
    return state


def _basis_update(pa: ProblemArrays, state: SDState, res: LPResult,
                  o_idx: int, k: int, tol: float) -> SDState:
    """An optimal subproblem: dedup its basis into the basis pool
    (stocUpdate.c:39-127)."""
    nd = pa.rv_d_cols.shape[0]
    n2 = pa.D.shape[1]
    Bcap = state.obs_feas.shape[0]
    lo, hi, O = obs_range(state)
    live = min(state.basis_cnt, Bcap)
    cstat8 = res.cstat.to(torch.int8)
    rstat8 = res.rstat.to(torch.int8)

    # ---- dedup 1: identical (cstat, rstat), compared exactly
    # (stocUpdate.c:39-53) ----
    same = torch.all(state.basis_cstat[:live] == cstat8, dim=1) & \
        torch.all(state.basis_rstat[:live] == rstat8, dim=1) & \
        state.basis_feas[:live]
    if bool(torch.any(same)):
        return state

    # ---- calcBasis (randCost.c:19-123): phi rows, psi tableau, gBar ----
    oc = min(o_idx, O - 1)      # past an overflowed omega pool: the last row
    delta_d = omega_row(state, oc)[_cost_cols(pa)]                # [nd]
    eq = res.basis[:, None] == pa.rv_d_cols[None, :]              # [m2, nd]
    present = torch.any(eq, dim=0)                                # [nd]
    pos = torch.argmax(eq.to(torch.int8), dim=0)                  # [nd]
    phi = torch.where(present[:, None], res.binv[pos], 0.0)       # [nd, m2]
    psi = phi @ pa.D                                              # [nd, n2]
    dbar_B = torch.where(res.basis < n2,
                         pa.d_bar[torch.clamp(res.basis, 0, n2 - 1)], 0.0)
    gbar = pa.d_bar - (dbar_B @ res.binv) @ pa.D                  # [n2]
    pidet = res.pi - torch.where(present, delta_d, 0.0) @ phi     # [m2]
    mub = compute_mu(res)

    # Pool piDet and each phi row (stocUpdate.c:78-99).  As in the JAX
    # package every phi row is pooled, a zero row where its RV is nonbasic.
    state, lidx, new_lam = calc_lambda(pa, state, pidet, tol)
    state, sidx0, any_new = calc_sigma(pa, state, pidet, mub, lidx, new_lam,
                                       True, k, tol)
    pres = present.tolist()
    sidx_phi = [0] * nd
    for n in range(nd):
        state, lidx_n, new_lam_n = calc_lambda(pa, state, phi[n], tol)
        state, sidx_n, new_sig_n = calc_sigma(pa, state, phi[n], 0.0, lidx_n,
                                              new_lam_n, True, k, tol)
        if pres[n]:
            sidx_phi[n] = sidx_n
            any_new = any_new or new_sig_n
    sidx_phi = torch.as_tensor(sidx_phi, device=phi.device)

    # ---- dedup 2: the same sigma signature (stocUpdate.c:101-114) ----
    if not any_new:
        bp = state.basis_present[:live]
        feas_oc = state.obs_feas[:live, oc - lo] if lo <= oc < hi else \
            torch.zeros(live, dtype=torch.bool, device=phi.device)
        if state.shard is not None:     # column oc from its owner
            feas_oc = obs_max(feas_oc.to(torch.uint8), state.shard).bool()
        same2 = (state.basis_sigma0[:live] == sidx0) & \
            torch.all(bp == present[None], dim=1) & \
            torch.all(~bp | (state.basis_sigma_idx[:live] == sidx_phi[None]),
                      dim=1) & \
            state.basis_feas[:live] & feas_oc
        if bool(torch.any(same2)):
            return state

    # ---- store the basis, and its feasibility at every observation
    # (stocUpdate.c:119-127) ----
    bi = state.basis_cnt
    if bi < Bcap:
        state.basis_cstat[bi] = cstat8
        state.basis_rstat[bi] = rstat8
        state.basis_phi[bi] = phi
        state.basis_present[bi] = present
        state.basis_sigma0[bi] = sidx0
        state.basis_sigma_idx[bi] = sidx_phi
        state.basis_pidet[bi] = pidet
        state.basis_gbar[bi] = gbar
        state.basis_psi[bi] = psi
        state.basis_mub[bi] = mub
        state.basis_ck[bi] = k
        state.basis_feas[bi] = True
        feas_row = check_bases_obs(pa, phi[None], present[None], pidet[None],
                                   gbar[None], psi[None], cstat8[None],
                                   _wd(pa, state), tol)[0]
        state.obs_feas[bi] = feas_row & \
            (torch.arange(lo, hi, device=phi.device) < state.omega_cnt)
    return state._replace(basis_cnt=bi + 1)


def stochastic_updates_randcost(pa: ProblemArrays, state: SDState,
                                res: LPResult, o_idx: int, new_o: bool,
                                k: int, tol: float):
    """The random-cost variant of stochasticUpdates (stocUpdate.c:14-133)
    for one subproblem result (no lane axis).  Returns (state, 0): as
    ``stochastic_updates``, with no sigma index."""
    lo, hi, _ = obs_range(state)
    if new_o and lo <= o_idx < hi:      # by the column's owner
        state = delta_new_omega_column(pa, state, o_idx - lo)
        state = refresh_obs_feas_new_omega(pa, state, o_idx - lo, tol)
    if bool(res.status == STATUS_OPTIMAL):
        return _basis_update(pa, state, res, o_idx, k, tol), 0
    # Infeasible: only the Farkas ray enters the pools (a sigma entry with
    # feasFlag false); no basis is stored.
    return pool_dual(pa, state, res.farkas, ray_mub(pa, res.farkas), False,
                     k, tol)[0], 0


def stochastic_updates_randcost_batch(pa: ProblemArrays, state: SDState,
                                      res_b: LPResult, o_idxs, new_o, k: int,
                                      tol: float) -> SDState:
    """B subproblem results (``res_b`` with its lane axis): the basis
    machinery is per observation, so they are pooled one after another, in
    batch order, as the JAX package does (core/step.py:363-372)."""
    for i in range(len(o_idxs)):
        state, _ = stochastic_updates_randcost(
            pa, state, lane(res_b, i), int(o_idxs[i]), bool(new_o[i]), k, tol)
    return state


def _heights(T, WD, s0, sn, present):
    """H[b, o] = T[s0[b], o] + sum_n present[b, n] WD[o, n] T[sn[b, n], o]
    for the bases given by s0 [nb], sn [nb, nd], present [nb, nd].  The sum
    over n is elementwise, so a row's value does not depend on how many
    rows are computed at once."""
    acc = None
    for n in range(sn.shape[1]):
        mult = torch.where(present[:, n, None], WD[None, :, n], 0.0)
        term = mult * T[sn[:, n]]
        acc = term if acc is None else acc + term
    return T[s0] if acc is None else T[s0] + acc


def height_table_randcost(pa: ProblemArrays, state: SDState, x):
    """computeIstar's heights over (basis, observation) with the cost
    multipliers (stocUpdate.c:161-184, randCost branch), materialized over
    the whole basis pool: (H [B, O], valid [B, O], o_valid [O]).  The
    reference that ``triple_argmax_randcost`` is held against."""
    T, _, o_valid = height_table(pa, state, x)
    H = _heights(T, _wd(pa, state), state.basis_sigma0,
                 state.basis_sigma_idx, state.basis_present)
    ids = torch.arange(H.shape[0], device=H.device)
    b_valid = (ids < state.basis_cnt) & state.basis_feas
    return H, b_valid[:, None] & state.obs_feas, o_valid


def triple_argmax_randcost(pa: ProblemArrays, state: SDState, x, old_gate,
                           new_gate, block: int = 256):
    """The first argmax and the max over the basis pool for each
    observation under the three dual-stability masks (all valid bases; old,
    ``old_gate``; new, ``new_gate``; each [B] and ANDed with the pool's
    validity and ``obs_feas``), in blocks of ``block`` bases over the live
    prefix of the pool only: never the [B, nd, O] gather.  Returns (i_all,
    h_all, i_old, h_old, i_new, h_new, o_valid), each [O]; a column with no
    valid basis has height -1e300 at index 0."""
    T, _, o_valid = height_table(pa, state, x)                    # [S, O]
    WD = _wd(pa, state)
    dev, O = T.device, T.shape[1]
    live = min(state.basis_cnt, state.basis_sigma0.shape[0])
    neg = torch.full((O,), _NEG, dtype=T.dtype, device=dev)
    zero = torch.zeros(O, dtype=torch.int64, device=dev)
    best = [[zero, neg], [zero, neg], [zero, neg]]     # (index, height) x 3
    for lo in range(0, live, block):
        hi = min(lo + block, live)
        Hb = _heights(T, WD, state.basis_sigma0[lo:hi],
                      state.basis_sigma_idx[lo:hi],
                      state.basis_present[lo:hi])                 # [b, O]
        base = state.basis_feas[lo:hi, None] & state.obs_feas[lo:hi]
        for j, gate in enumerate((None, old_gate, new_gate)):
            mask = base if gate is None else base & gate[lo:hi, None]
            Hm = torch.where(mask, Hb, _NEG)
            h_blk = torch.amax(Hm, dim=0)
            i_blk = torch.argmax(Hm, dim=0) + lo      # first on ties
            # Strict: on equal heights the earlier block keeps its row.
            better = h_blk > best[j][1]
            best[j] = [torch.where(better, i_blk, best[j][0]),
                       torch.where(better, h_blk, best[j][1])]
    (ia, ha), (io, ho), (inw, hn) = best
    return ia, ha, io, ho, inw, hn, o_valid


def cut_argmax_randcost(pa: ProblemArrays, state: SDState, x, ns_eff: int):
    """``core/cuts.py::cut_argmax`` on the basis pool: the "old" bases were
    found at ``basis_ck <= ns_eff``.  Plain PyTorch, as the JAX package's
    XLA version; no CUDA kernel."""
    ck = state.basis_ck
    return triple_argmax_randcost(pa, state, x, ck <= ns_eff, ck > ns_eff)


def accumulate_randcost(pa: ProblemArrays, state: SDState, istar, o_valid,
                        k: int):
    """The cut's (alpha, beta) with the cost multipliers (cuts.c:142-159)."""
    n1 = pa.c1.shape[0]
    dtype, dev = state.sigma_pib.dtype, istar.device
    o_ids = torch.arange(istar.shape[0], device=dev)
    w = torch.where(o_valid, state.omega_w, 0).to(dtype)          # [O]
    s0 = state.basis_sigma0[istar]                                # [O]
    sn = state.basis_sigma_idx[istar]                             # [O, nd]
    mult = torch.where(state.basis_present[istar], _wd(pa, state), 0.0)
    l0, ln = state.sigma_lidx[s0], state.sigma_lidx[sn]

    pib0 = state.sigma_pib[s0] + state.delta_pib[l0, o_ids]
    pibn = state.sigma_pib[sn] + state.delta_pib[ln, o_ids[:, None]]
    alpha = torch.sum(w * (pib0 + torch.sum(mult * pibn, dim=1))) / k

    beta = torch.zeros(n1, dtype=dtype, device=dev)
    if pa.C_cols.shape[0]:
        term = state.sigma_piC[s0] + torch.einsum(
            "on,onc->oc", mult, state.sigma_piC[sn])
        beta = beta.index_add(0, pa.C_cols,
                              torch.sum(w[:, None] * term, dim=0))
    if pa.C_cols_rand.shape[0] and pa.rv_C_rows.shape[0]:
        term = state.delta_piC[l0, o_ids] + torch.einsum(
            "on,onc->oc", mult, state.delta_piC[ln, o_ids[:, None]])
        beta = beta.index_add(0, pa.C_cols_rand,
                              torch.sum(w[:, None] * term, dim=0))
    return alpha, beta / k


def reform_sums_randcost(pa: ProblemArrays, state: SDState, counts):
    """reformCuts (optimal.c:187-236) with the cost multipliers: every
    cut's (alpha, beta) under each row of resampled observation counts
    [R, O], from its stored per-observation basis indices, before the lb
    correction (``stopping.with_lb``); returns (alpha [R, K],
    beta [R, K, n1], the counted observations known to each cut [R, K])."""
    K, O = state.cut_istar.shape
    n1 = pa.c1.shape[0]
    dtype, dev = pa.c1.dtype, pa.c1.device
    kf = float(state.k)
    R = counts.shape[0]
    lo, _, _ = obs_range(state)
    o_ids = torch.arange(O, device=dev)
    valid = ((lo + o_ids)[None, :] <
             state.cut_omega_cnt[:, None]).to(dtype)
    cnt = counts.to(dtype)                                        # [R, O]

    istar = state.cut_istar                                       # [K, O]
    s0 = state.basis_sigma0[istar]                                # [K, O]
    sn = state.basis_sigma_idx[istar]                             # [K, O, nd]
    mult = torch.where(state.basis_present[istar], _wd(pa, state)[None],
                       0.0)                                       # [K, O, nd]
    l0, ln = state.sigma_lidx[s0], state.sigma_lidx[sn]
    pib0 = state.sigma_pib[s0] + state.delta_pib[l0, o_ids[None, :]]
    pibn = state.sigma_pib[sn] + state.delta_pib[ln, o_ids[None, :, None]]
    val = valid * (pib0 + torch.sum(mult * pibn, dim=2))          # [K, O]
    alpha = cnt @ val.T / kf                                      # [R, K]

    def per_cut(term):                        # [K, O, c] -> [R, K, c]
        c = term.shape[2]
        t = (valid[:, :, None] * term).permute(1, 0, 2).reshape(O, K * c)
        return (cnt @ t).reshape(R, K, c)

    beta = torch.zeros((R, K, n1), dtype=dtype, device=dev)
    if pa.C_cols.shape[0]:
        beta[:, :, pa.C_cols] += per_cut(state.sigma_piC[s0] + torch.einsum(
            "kon,konc->koc", mult, state.sigma_piC[sn]))
    if pa.C_cols_rand.shape[0] and pa.rv_C_rows.shape[0]:
        beta[:, :, pa.C_cols_rand] += per_cut(
            state.delta_piC[l0, o_ids[None, :]] + torch.einsum(
                "kon,konc->koc", mult,
                state.delta_piC[ln, o_ids[None, :, None]]))
    return alpha, beta / kf, cnt @ valid.T
