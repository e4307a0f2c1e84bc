"""One SD iteration, batch 1 (one observation per iteration).

Composes the reference hot path (solveCell body, algo.c:127-183):
draw observation -> dedup -> candidate subproblem + stochastic updates +
candidate cut -> incumbent cut every TAU -> incumbent-improvement check ->
regularized QP master.  The port of the batch-1 branch of the JAX package's
``core/step.py::make_step``; the host reads back the few scalars each
decision needs.
"""

from __future__ import annotations

import torch

from stochasticdecomposition_torch.config import MASTER_QP, SDConfig
from stochasticdecomposition_torch.core.cuts import (
    add_cut, form_cut, max_cut_height,
)
from stochasticdecomposition_torch.core.master import build_and_solve_master
from stochasticdecomposition_torch.core.state import ProblemArrays, SDState
from stochasticdecomposition_torch.core.update import (
    calc_omega, stochastic_updates, warm_solve_subproblem,
)
from stochasticdecomposition_torch.ops.simplex import STATUS_OPTIMAL
from stochasticdecomposition_torch.sampler import SamplerSpec, sample_omega


def check_supported(pa: ProblemArrays, cfg: SDConfig) -> None:
    """Raise for the configurations this slice of the port does not run."""
    if cfg.MASTER_TYPE != MASTER_QP:
        raise NotImplementedError(
            f"MASTER_TYPE={cfg.MASTER_TYPE}: only the regularized QP master "
            "(MASTER_TYPE 5) is ported")
    if cfg.SAMPLE_INCREMENT != 1:
        raise NotImplementedError(
            "SAMPLE_INCREMENT > 1 (batched sampling) is not ported yet")
    if cfg.CHECK_EVERY != 1:
        raise NotImplementedError("CHECK_EVERY > 1 is not ported")
    if cfg.SUBPROB_F32_PIVOT:
        raise NotImplementedError(
            "SUBPROB_F32_PIVOT: the port's subproblem solves pivot in f64")
    if int(pa.rv_d_cols.shape[0]) > 0:
        raise NotImplementedError(
            "random cost coefficients (the v2.0 path) are not ported yet")


def make_step(pa: ProblemArrays, spec: SamplerSpec, cfg: SDConfig):
    """Build the SD iteration ``step(state, gen, w_raw=None) -> state``.

    ``gen`` draws the observation; ``w_raw`` (raw, uncentered [R]) injects
    it instead, so tests can feed the port the JAX package's draws."""
    check_supported(pa, cfg)
    tol = cfg.TOLERANCE
    dtype = pa.c1.dtype

    def _form_sd_cut(state: SDState, x, o_idx: int, new_o: bool, k: int,
                     incumbent: bool):
        """formSDCut (cuts.c:22-89): solve subproblem, run stochastic
        updates, build the SD cut via argmax, add it to pool."""
        w = state.omega_vals[o_idx]
        res, state = warm_solve_subproblem(pa, state, x, w)
        sp_feas = bool(res.status == STATUS_OPTIMAL)
        state = state._replace(lp_cnt=state.lp_cnt + 1,
                               lp_pivots=state.lp_pivots + int(res.iters),
                               sp_feas=state.sp_feas and sp_feas)
        state, _ = stochastic_updates(pa, state, res, o_idx, new_o, k, tol)
        parts, state = form_cut(
            pa, state, x, k,
            dual_stability=cfg.DUAL_STABILITY,
            pi_eval_start=cfg.PI_EVAL_START,
            pi_cycle=cfg.PI_CYCLE,
            scan_len=cfg.eff_scan_len())
        return add_cut(pa, state, parts, k, incumbent=incumbent, tol=tol)

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
                norm_dk_1=s.norm_dk,
                gamma=torch.zeros((), dtype=dtype, device=qs.device))
        # No improvement: strengthen the proximal term (soln.c:50-51).
        return s._replace(
            quad_scalar=torch.clamp(s.quad_scalar / cfg.R2,
                                    max=cfg.MAX_QUAD_SCALAR),
            norm_dk_1=s.norm_dk)

    def step(state: SDState, gen: torch.Generator | None = None,
             w_raw=None) -> SDState:
        k = state.k + 1
        state = state._replace(k=k, sp_feas=True, cut_ok=True)

        # 2. generateOmega + mean-centering + dedup (algo.c:145-152).
        if w_raw is None:
            w_raw = sample_omega(spec, gen, 1, dtype=dtype)[0]
        w = w_raw.to(dtype) - pa.omega_mean
        state, o_idx, new_o = calc_omega(state, w, tol)
        state = state._replace(last_o_idx=o_idx)
        # 3. candidate cut (algo.c:155).
        state, cand_slot = _form_sd_cut(
            state, state.candid_x, o_idx, new_o, k, incumbent=False)

        # 4. incumbent cut every TAU iterations (algo.c:161-166).
        if (k - state.i_cut_updt) % cfg.TAU == 0:
            state, _ = _form_sd_cut(state, state.incumb_x, state.last_o_idx,
                                    False, k, incumbent=True)
        # 5. incumbent improvement check (algo.c:169-171).
        if not state.incumb_chg and k > 1:
            state = _check_improvement(state, cand_slot, k)

        # 6. master QP (algo.c:174, master.c:18-88).
        return master_step(state, k)

    def master_step(state: SDState, k: int) -> SDState:
        res = build_and_solve_master(pa, state, k)
        candid_est = pa.c1 @ res.x + max_cut_height(pa, state, res.x, k)
        return state._replace(
            candid_x=res.x,
            candid_est=candid_est,
            gamma=candid_est - state.incumb_est,
            norm_dk=res.d_norm2,
            norm_dk_1=res.d_norm2 if k == 1 else state.norm_dk_1,
            pi_first=res.pi_first,
            pi_cuts=res.pi_cuts,
            dj_master=res.dj,
            eta=res.eta,
            master_ok=state.master_ok and res.ok,
            qp_iters=state.qp_iters + res.iters,
        )

    return step
