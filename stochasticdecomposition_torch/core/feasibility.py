"""Feasibility-cut machinery (induced constraints).

Reference: cuts.c:398-567.  When a subproblem is infeasible at the
candidate, the algorithm enters feasibility mode: the dual extreme rays
(stored in the pools with feasFlag false by the stochastic updates) are
crossed with every observation into feasibility cuts  beta'x >= alpha
(updtFeasCutPool, cuts.c:465-517), the violated ones enter the master
(checkFeasCutPool, cuts.c:521-567), the proximal term is relaxed, and master
and subproblem solves alternate until the candidate is feasible
(resolveInfeasibility, cuts.c:402-449).

The port of the JAX package's ``core/feasibility.py``: a rare,
control-flow-heavy path that runs on the host with numpy, over the few
(ray, observation) pairs gathered on the device, and calls the step's
substeps (core/step.py::make_substeps) for the solves.  On a state
sharded over obs ranks each rank reads the pairs' delta entries in its own
observation columns, and a sum over the ranks of the zero-padded entries
gives every rank all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import (
    ProblemArrays, SDState, obs_range,
)
from stochasticdecomposition_torch.parallel.distributed import obs_sum

MAX_FEAS_ROUNDS = 200   # master/subproblem rounds before feasibility mode fails


def update_feas_cut_pool(pa: ProblemArrays, state: SDState, cfg: SDConfig,
                         pool_alpha, pool_beta):
    """updtFeasCutPool (cuts.c:465-517): cross the new (ray, observation)
    pairs into the host-side pool (lists ``pool_alpha``/``pool_beta``,
    extended in place) with dedup; the watermarks are ``state.f_updt``.

    As in the JAX package the dedup keys are the cuts quantized by
    TOLERANCE (``np.unique``): two cuts within TOLERANCE of each other may
    both be kept, which is harmless (``check_feas_cut_pool`` dedups the
    slots again).  Returns (state, pool_alpha, pool_beta)."""
    tol = cfg.TOLERANCE
    n1 = pa.c1.shape[0]
    s_mark, o_mark = state.f_updt
    s_cnt, o_cnt = state.sigma_cnt, state.omega_cnt
    feas_flags = state.sigma_feas[:s_cnt].cpu().numpy()

    # (ray, obs) index cross products: new obs x old rays + all obs x new
    # rays (cuts.c:472-514).
    old_rays = np.where(~feas_flags[:s_mark])[0]
    new_rays = s_mark + np.where(~feas_flags[s_mark:s_cnt])[0]
    pairs_s = np.concatenate([
        np.repeat(old_rays, max(o_cnt - o_mark, 0)),
        np.repeat(new_rays, o_cnt),
    ]).astype(np.int64)
    pairs_o = np.concatenate([
        np.tile(np.arange(o_mark, o_cnt), len(old_rays)),
        np.tile(np.arange(o_cnt), len(new_rays)),
    ]).astype(np.int64)
    state = state._replace(f_updt=(s_cnt, o_cnt))
    if pairs_s.size == 0:
        return state, pool_alpha, pool_beta

    # Only the pairs' entries leave the device.
    dev = state.sigma_pib.device
    ps = torch.as_tensor(pairs_s, device=dev)
    po = torch.as_tensor(pairs_o, device=dev)
    lidx = state.sigma_lidx[ps]
    # The pairs' delta entries in this state's columns, zeros elsewhere.
    lo, hi, _ = obs_range(state)
    mine = (po >= lo) & (po < hi)
    col = torch.where(mine, po - lo, 0)
    d = torch.cat([state.delta_pib[lidx, col][:, None],
                   state.delta_piC[lidx, col]], dim=1)
    d = obs_sum(torch.where(mine[:, None], d, 0.0), state.shard)
    alpha = (state.sigma_pib[ps] + d[:, 0]).cpu().numpy()
    beta = np.zeros((len(pairs_s), n1))
    C_cols = pa.C_cols.cpu().numpy()
    if C_cols.size:
        beta[:, C_cols] += state.sigma_piC[ps].cpu().numpy()
    if pa.rv_C_rows.shape[0] and pa.C_cols_rand.shape[0]:
        beta[:, pa.C_cols_rand.cpu().numpy()] += d[:, 1:].cpu().numpy()

    # Tolerance-quantized dedup, within the batch and against the pool.
    keys = np.round(np.concatenate([alpha[:, None], beta], axis=1) / tol)
    _, first = np.unique(keys, axis=0, return_index=True)
    if pool_alpha:
        pool_keys = np.round(np.concatenate(
            [np.asarray(pool_alpha)[:, None], np.stack(pool_beta)],
            axis=1) / tol)
        pool_set = {k.tobytes() for k in pool_keys.astype(np.int64)}
    else:
        pool_set = set()
    for i in sorted(first):
        kb = keys[i].astype(np.int64).tobytes()
        if kb not in pool_set:
            pool_set.add(kb)
            pool_alpha.append(float(alpha[i]))
            pool_beta.append(beta[i])
    return state, pool_alpha, pool_beta


def check_feas_cut_pool(pa: ProblemArrays, state: SDState, cfg: SDConfig,
                        pool_alpha, pool_beta) -> SDState:
    """checkFeasCutPool (cuts.c:521-567): put the pool's cuts that the
    incumbent violates (which sets ``infeas_incumb``) or the candidate
    violates into free feasibility cut slots of the master."""
    tol = cfg.TOLERANCE
    fa = state.fcut_alpha.cpu().numpy().copy()
    fb = state.fcut_beta.cpu().numpy().copy()
    fm = state.fcut_mask.cpu().numpy().copy()
    incumb = state.incumb_x.cpu().numpy()
    candid = state.candid_x.cpu().numpy()
    infeas_incumb = state.infeas_incumb

    def _active_dup(alpha, beta):
        for j in np.where(fm)[0]:
            if abs(alpha - fa[j]) < tol and np.all(np.abs(beta - fb[j]) < tol):
                return True
        return False

    def _activate(alpha, beta):
        free = np.where(~fm)[0]
        if free.size == 0:
            raise RuntimeError(
                "feasibility cut slots exhausted; raise CUT_MULT")
        j = free[0]
        fa[j] = alpha
        fb[j] = beta
        fm[j] = True

    for alpha, beta in zip(pool_alpha, pool_beta):
        dup = _active_dup(alpha, beta)
        if beta @ incumb < alpha - tol:
            infeas_incumb = True
            if not dup:
                _activate(alpha, beta)
        elif not dup and beta @ candid < alpha - tol:
            _activate(alpha, beta)

    dev, dtype = state.fcut_alpha.device, state.fcut_alpha.dtype
    return state._replace(
        fcut_alpha=torch.as_tensor(fa, dtype=dtype, device=dev),
        fcut_beta=torch.as_tensor(fb, dtype=dtype, device=dev),
        fcut_mask=torch.as_tensor(fm, device=dev),
        infeas_incumb=infeas_incumb)


def resolve_infeasibility(pa: ProblemArrays, state: SDState, cfg: SDConfig,
                          substeps, pool_alpha, pool_beta):
    """resolveInfeasibility (cuts.c:402-449): alternate feasibility-cut
    generation and master solves until the subproblem is feasible at the
    candidate, then form the cut the infeasible solve interrupted.
    ``substeps`` is ``core/step.py::make_substeps``'s dict.  Returns
    (state, pool_alpha, pool_beta)."""
    state = state._replace(opt_mode=False)
    rounds = 0
    while True:
        rounds += 1
        if rounds > MAX_FEAS_ROUNDS:
            raise RuntimeError("feasibility mode failed to converge")
        state, pool_alpha, pool_beta = update_feas_cut_pool(
            pa, state, cfg, pool_alpha, pool_beta)
        state = check_feas_cut_pool(pa, state, cfg, pool_alpha, pool_beta)
        # Relax the proximal term (cuts.c:412-417).
        state = state._replace(
            quad_scalar=torch.full_like(state.quad_scalar,
                                        cfg.MIN_QUAD_SCALAR),
            feas_cnt=state.feas_cnt + 1)
        state = substeps["master_step"](state)
        if not state.master_ok:
            raise RuntimeError("master failed during feasibility mode")
        state = substeps["subprob_update"](state)
        if state.sp_feas:
            break

    # Feasibility restored: form the optimality cut formSDCut was about to
    # build when the infeasible subproblem interrupted it (SDCut runs after
    # resolveInfeasibility returns, cuts.c:40-56).  If the pool still holds
    # only ray entries the cut is skipped (cut_ok False), never stored.
    state = substeps["cut_step"](state)

    # An infeasible incumbent is replaced by the (feasible) candidate
    # (cuts.c:440-443, soln.c:62-94).  The state's tensors are written in
    # place elsewhere, so the incumbent gets copies, never the candidate's
    # own tensors.
    if state.infeas_incumb:
        state = state._replace(
            incumb_x=state.candid_x.clone(),
            incumb_est=state.candid_est.clone(),
            i_cut_updt=state.k, incumb_chg=True, infeas_incumb=False,
            gamma=torch.zeros_like(state.gamma))
    return state._replace(opt_mode=True), pool_alpha, pool_beta
