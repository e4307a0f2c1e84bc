"""One SD iteration: one observation, or SAMPLE_INCREMENT of them.

Composes the reference hot path (solveCell body, algo.c:127-183):
draw observation -> dedup -> candidate subproblem + stochastic updates +
candidate cut -> incumbent cut every TAU -> incumbent-improvement check ->
regularized QP master.  The port of the JAX package's
``core/step.py::make_step``, batch 1 and batched, with CHECK_EVERY steps per
call; the host reads back the few scalars each decision needs.  A state
sharded over obs ranks (``SDState.shard``) steps the same way on every rank
of its group: the observations a step solves at come from the ranks that
store them (``core/update.omega_rows``), and the modules below combine the
ranks' columns.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from stochasticdecomposition_torch.config import (
    MASTER_LP, MASTER_MILP, SDConfig,
)
from stochasticdecomposition_torch.core.cuts import (
    accumulate, add_cut, cut_argmax, form_cut, max_cut_height,
)
from stochasticdecomposition_torch.core.master import (
    build_and_solve_master, build_and_solve_master_lp,
)
from stochasticdecomposition_torch.core.randcost import (
    accumulate_randcost, cut_argmax_randcost, reform_sums_randcost,
    stochastic_updates_randcost, stochastic_updates_randcost_batch,
)
from stochasticdecomposition_torch.core.state import (
    ProblemArrays, SDState, obs_range,
)
from stochasticdecomposition_torch.core.stopping import reform_sums
from stochasticdecomposition_torch.core.update import (
    calc_omega, calc_omega_batch, omega_row, omega_rows, stochastic_updates,
    stochastic_updates_batch, subproblem_rhs_cost_lanes,
    warm_solve_subproblem,
)
from stochasticdecomposition_torch.ops.simplex import (
    AT_UPPER, STATUS_OPTIMAL, solve_lp,
)
from stochasticdecomposition_torch.sampler import SamplerSpec, sample_omega


class Path(NamedTuple):
    """The functions in which the plain path and the random-cost path
    (v2.0: randCost.c, core/randcost.py) differ, chosen once per problem."""
    updates: Callable         # stochasticUpdates for one subproblem result
    updates_batch: Callable   # ... for B results with a lane axis
    argmax: Callable          # computeIstar's three masked argmaxes
    accumulate: Callable      # the cut's (alpha, beta)
    reform: Callable          # reformCuts' sums for the bootstrap


def problem_path(pa: ProblemArrays) -> Path:
    """The random-cost path when the problem has random cost coefficients
    (``pa.rv_d_cols``), else the plain one, whose argmax is the CUDA
    kernel."""
    if pa.rv_d_cols.shape[0]:
        return Path(stochastic_updates_randcost,
                    stochastic_updates_randcost_batch, cut_argmax_randcost,
                    accumulate_randcost, reform_sums_randcost)
    return Path(stochastic_updates, stochastic_updates_batch, cut_argmax,
                accumulate, reform_sums)


def lp_master(cfg: SDConfig) -> bool:
    """Whether the master is solved as an LP (MASTER_TYPE 0, and the
    relaxations of MILP's 1): no incumbent and no proximal term."""
    return cfg.MASTER_TYPE in (MASTER_LP, MASTER_MILP)


def _cut(pa: ProblemArrays, cfg: SDConfig, path: Path, state: SDState, x,
         k: int, incumbent: bool):
    """SDCut + addCut2Pool on the current pools (cuts.c:40-89); counts the
    cut in ``cut_cnt``.  Returns (state, slot)."""
    parts, state = form_cut(
        pa, state, x, k,
        dual_stability=cfg.DUAL_STABILITY,
        pi_eval_start=cfg.PI_EVAL_START,
        pi_cycle=cfg.PI_CYCLE,
        # The ratio window holds one entry per step, SCAN_LEN samples.
        scan_len=cfg.eff_scan_len(), batch=max(1, int(cfg.SAMPLE_INCREMENT)),
        argmax=path.argmax, accumulate=path.accumulate)
    state = state._replace(cut_cnt=state.cut_cnt + 1)
    return add_cut(pa, state, parts, k, incumbent=incumbent,
                   tol=cfg.TOLERANCE)


def _master(pa: ProblemArrays, cfg: SDConfig, state: SDState,
            k: int) -> SDState:
    """The master solve and the candidate it gives (algo.c:174,
    master.c:18-88).  In LP mode the candidate doubles as the reported
    solution (no incumbent, setup.c:113-119; inout.c:27-30)."""
    lp = lp_master(cfg)
    res = (build_and_solve_master_lp if lp else build_and_solve_master)(
        pa, state, k)
    candid_est = pa.c1 @ res.x + max_cut_height(pa, state, res.x, k)
    state = state._replace(
        candid_x=res.x,
        candid_est=candid_est,
        gamma=candid_est - state.incumb_est,
        norm_dk=res.d_norm2,
        pi_first=res.pi_first,
        pi_cuts=res.pi_cuts,
        dj_master=res.dj,
        eta=res.eta,
        master_ok=state.master_ok and res.ok,
        qp_iters=state.qp_iters + res.iters,
    )
    if lp:
        state = state._replace(incumb_x=res.x.clone(),
                               incumb_est=candid_est.clone(),
                               gamma=torch.zeros_like(candid_est))
    return state


def make_substeps(pa: ProblemArrays, cfg: SDConfig):
    """The pieces the host feasibility-mode loop calls (resolveInfeasibility,
    cuts.c:402-449; core/feasibility.py), as the JAX package's
    ``make_substeps``: a subproblem solve plus updates at the candidate, a
    master-only solve, and the cut formSDCut forms once feasibility is
    restored (cuts.c:40-56), which goes through the path's argmax (the CUDA
    kernel on the plain path) and counts in ``cut_cnt``."""
    tol = cfg.TOLERANCE
    path = problem_path(pa)

    def subprob_update(state: SDState) -> SDState:
        o_idx = state.last_o_idx
        res, state = warm_solve_subproblem(pa, state, state.candid_x,
                                           omega_row(state, o_idx))
        state = state._replace(
            lp_cnt=state.lp_cnt + 1,
            lp_pivots=state.lp_pivots + int(res.iters),
            sp_feas=bool(res.status == STATUS_OPTIMAL))
        state, _ = path.updates(pa, state, res, o_idx, False, state.k, tol)
        return state

    def master_step(state: SDState) -> SDState:
        return _master(pa, cfg, state, state.k)

    def cut_step(state: SDState) -> SDState:
        state, _ = _cut(pa, cfg, path, state._replace(cut_ok=True),
                        state.candid_x, state.k, incumbent=False)
        return state

    return {"subprob_update": subprob_update, "master_step": master_step,
            "cut_step": cut_step}


def make_step(pa: ProblemArrays, spec: SamplerSpec, cfg: SDConfig):
    """Build the SD iteration ``step(state, gen, w_raw=None) -> state``.

    One step draws SAMPLE_INCREMENT = B observations and advances ``k``
    (which counts samples) by B; CHECK_EVERY steps run per call.  ``gen``
    draws the observations; ``w_raw`` (raw, uncentered: [R] or [B, R], and
    [CHECK_EVERY, B, R] for several steps) injects them instead, so tests
    can feed the port the JAX package's draws.  SUBPROB_F32_PIVOT and
    SUBPROB_STAGED_BATCH are accepted and change nothing: the subproblems
    are solved in f64, all B lanes in one pass (ops/simplex.lane_cap).
    Under MASTER_TYPE 0/1 the master is the LP and the step forms no
    incumbent cut and makes no improvement check."""
    tol = cfg.TOLERANCE
    dtype = pa.c1.dtype
    batch = max(1, int(cfg.SAMPLE_INCREMENT))
    chunk = max(1, int(cfg.CHECK_EVERY))
    lp = lp_master(cfg)
    path = problem_path(pa)

    def _form_sd_cut(state: SDState, x, w, o_idx: int, new_o: bool, k: int,
                     incumbent: bool):
        """formSDCut (cuts.c:22-89): solve subproblem at the stored
        observation ``w`` (index ``o_idx``), run stochastic updates, build
        the SD cut via argmax, add it to pool."""
        res, state = warm_solve_subproblem(pa, state, x, w)
        sp_feas = bool(res.status == STATUS_OPTIMAL)
        state = state._replace(lp_cnt=state.lp_cnt + 1,
                               lp_pivots=state.lp_pivots + int(res.iters),
                               sp_feas=state.sp_feas and sp_feas)
        state, _ = path.updates(pa, state, res, o_idx, new_o, k, tol)
        return _cut(pa, cfg, path, state, x, k, incumbent)

    def _batched_candidate_cut(state: SDState, w_batch, k: int):
        """The B observations of a step: dedup, one lane-batched solve at
        the candidate warm-started from the carried basis, pooling, and one
        candidate cut over the enlarged sample (JAX core/step.py:245-380).
        Returns (state, slot, the last observation of the batch)."""
        state, o_idxs, new_flags = calc_omega_batch(state, w_batch, tol)
        state = state._replace(last_o_idx=int(o_idxs[-1]))
        # Past an overflowed omega pool read the last row, as the JAX
        # package's gather does; the runner then raises on the overflow.
        O = obs_range(state)[2]
        rows = torch.as_tensor(np.minimum(o_idxs, O - 1),
                               device=w_batch.device)
        ws = omega_rows(state, rows)
        rhs, cost = subproblem_rhs_cost_lanes(pa, state.candid_x, ws)
        B = ws.shape[0]
        res_b = solve_lp(
            pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs,
            init_basis=state.warm_basis.expand(B, -1),
            init_at_upper=state.warm_atup.expand(B, -1))
        # The next warm start is the basis of the optimal lane whose
        # centered observation is nearest the mean (the most typical
        # scenario of the batch, JAX core/step.py:339-354).
        okb = res_b.status == STATUS_OPTIMAL
        score = torch.where(okb, -torch.sum(ws * ws, dim=1), -math.inf)
        # One host sync for the lane, the optimal count and the pivots.
        li, n_ok, pivots = torch.stack(
            [torch.argmax(score), torch.sum(okb),
             torch.sum(res_b.iters)]).tolist()
        if n_ok > 0:
            state = state._replace(
                warm_basis=res_b.basis[li].clone(),
                warm_atup=torch.cat([res_b.cstat[li], res_b.rstat[li]])
                == AT_UPPER)
        state = state._replace(
            lp_cnt=state.lp_cnt + B,
            lp_pivots=state.lp_pivots + pivots,
            lane_iters=res_b.iters,
            sp_feas=state.sp_feas and n_ok == B)
        state = path.updates_batch(pa, state, res_b, o_idxs, new_flags, k,
                                   tol)
        return (*_cut(pa, cfg, path, state, state.candid_x, k,
                      incumbent=False), ws[-1])

    def _check_improvement(state: SDState, cand_slot: int, k: int):
        """checkImprovement / replaceIncumbent (soln.c:24-94)."""
        candid_est = pa.c1 @ state.candid_x + \
            max_cut_height(pa, state, state.candid_x, k)
        incumb_est = pa.c1 @ state.incumb_x + \
            max_cut_height(pa, state, state.incumb_x, k)
        state = state._replace(incumb_est=incumb_est)

        # An uncertified master candidate is never promoted to incumbent.
        improved = state.master_ok and \
            bool((candid_est - incumb_est) < cfg.R1 * state.gamma)
        s = state
        if improved:
            # Proximal rescale (soln.c:69-74).
            qs = s.quad_scalar
            grow = (s.norm_dk > tol) & (s.norm_dk >= cfg.R3 * s.norm_dk_1)
            qs_new = torch.clamp(
                qs * cfg.R2 * cfg.R3 * s.norm_dk_1 /
                torch.where(s.norm_dk > tol, s.norm_dk, 1.0),
                cfg.MIN_QUAD_SCALAR, cfg.MAX_QUAD_SCALAR)
            return s._replace(
                incumb_x=s.candid_x, incumb_est=candid_est,
                quad_scalar=torch.where(grow, qs_new, qs),
                i_cut_idx=cand_slot, i_cut_updt=k, incumb_chg=False,
                norm_dk_1=s.norm_dk, infeas_incumb=False,
                gamma=torch.zeros((), dtype=dtype, device=qs.device))
        # No improvement: strengthen the proximal term (soln.c:50-51), once
        # per master solve, or once per sample under QS_RELAX_PER_SAMPLE.
        relax = cfg.R2 ** batch if cfg.QS_RELAX_PER_SAMPLE else cfg.R2
        return s._replace(
            quad_scalar=torch.clamp(s.quad_scalar / relax,
                                    max=cfg.MAX_QUAD_SCALAR),
            norm_dk_1=s.norm_dk)

    def one_step(state: SDState, gen, w_raw) -> SDState:
        k = state.k + batch
        state = state._replace(k=k, sp_feas=True, cut_ok=True)

        # 2. generateOmega + mean-centering + dedup (algo.c:145-152).
        if w_raw is None:
            w_raw = sample_omega(spec, gen, batch, dtype=dtype)
        w = w_raw.to(dtype).reshape(batch, -1) - pa.omega_mean[None]
        if batch == 1:
            state, o_idx, new_o = calc_omega(state, w[0], tol)
            state = state._replace(last_o_idx=o_idx)
            # A new observation is stored as drawn; a match is read back.
            row = w[0] if new_o else omega_row(state, o_idx)
            # 3. candidate cut (algo.c:155).
            state, cand_slot = _form_sd_cut(
                state, state.candid_x, row, o_idx, new_o, k, incumbent=False)
            do_inc = (k - state.i_cut_updt) % cfg.TAU == 0
        else:
            state, cand_slot, row = _batched_candidate_cut(state, w, k)
            do_inc = (k - state.i_cut_updt) >= cfg.TAU

        # 4. incumbent cut every TAU iterations (algo.c:161-166) and 5. the
        # incumbent improvement check (algo.c:169-171): QP-master
        # machinery, absent in LP mode (setup.c:113-119).
        if not lp:
            if do_inc:
                state, _ = _form_sd_cut(state, state.incumb_x, row,
                                        state.last_o_idx, False, k,
                                        incumbent=True)
            if not state.incumb_chg and k > 1:
                state = _check_improvement(state, cand_slot, k)

        # 6. master QP or LP (algo.c:174, master.c:18-88).
        state = _master(pa, cfg, state, k)
        return state._replace(norm_dk_1=state.norm_dk) if k == 1 else state

    def step(state: SDState, gen: torch.Generator | None = None,
             w_raw=None) -> SDState:
        if chunk == 1:
            return one_step(state, gen, w_raw)
        # CHECK_EVERY steps with no host gate between them (the JAX
        # package's lax.scan chunk, core/step.py:424-433).
        if w_raw is not None:
            w_raw = torch.as_tensor(w_raw).reshape(chunk, batch, -1)
        for i in range(chunk):
            state = one_step(state, gen, None if w_raw is None else w_raw[i])
        return state

    return step
