"""The master problem: the regularized QP in d-space (MASTER_TYPE 5, and
the relaxations of MIQP's 7) and the LP in x-space (MASTER_TYPE 0, and the
relaxations of MILP's 1).

Reference: master.c.  The reference mutates a persistent CPLEX model
(changeEtaCol k/j rescaling at master.c:146-161, RHS lb-shifts at
master.c:163-188, proximal reload at master.c:191-211).  Here, as in the JAX
package, the master is a pure function of the cut pool, incumbent and
proximal scalar, rebuilt every iteration.

Variables v = [d ; eta], d = x - incumbent:
    min  c'd + eta + (sigma/2)||d||^2
    s.t. A1 d {sense} b1 - A1 xbar
         (k/ns_j) eta + beta_j'd >= alpha_j - beta_j'xbar + (k/ns_j - 1) lb
         beta_f'd >= alpha_f - beta_f'xbar          (feasibility cuts)
         l - xbar <= d <= u - xbar
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stochasticdecomposition_torch.core.state import ProblemArrays, SDState
from stochasticdecomposition_torch.ops.qp import solve_qp
from stochasticdecomposition_torch.ops.simplex import STATUS_OPTIMAL, solve_lp


class MasterResult(NamedTuple):
    x: torch.Tensor           # new candidate (incumbent + d)
    eta: torch.Tensor
    d_norm2: torch.Tensor     # ||d||^2
    pi_first: torch.Tensor    # [m1] duals, CPLEX sign convention
    pi_cuts: torch.Tensor     # [K] cut-row duals (>= 0)
    dj: torch.Tensor          # [n1] reduced costs (bound duals, zl - zu)
    obj: torch.Tensor
    ok: bool                  # converged flag
    iters: int                # interior-point iterations (LP: pivots)


def build_and_solve_master(pa: ProblemArrays, state: SDState, k: int,
                           *, tol: float = 1e-9, l1=None,
                           u1=None) -> MasterResult:
    """``l1``/``u1`` replace the first-stage bounds: the box of a
    branch-and-bound node (core/bnb.py)."""
    dtype, dev = pa.c1.dtype, pa.c1.device
    n1 = pa.c1.shape[0]
    m1 = pa.b1.shape[0]
    K = state.cut_mask.shape[0]
    F = state.fcut_mask.shape[0]
    nv = n1 + 1
    xbar = state.incumb_x

    Q = torch.zeros((nv, nv), dtype=dtype, device=dev)
    Q[torch.arange(n1), torch.arange(n1)] = state.quad_scalar
    c = torch.cat([pa.c1, torch.ones(1, dtype=dtype, device=dev)])

    b_shift = pa.b1 - pa.A1 @ xbar

    # --- equality rows (first-stage '=' constraints) ---------------------
    eq_mask = pa.sense1 == 0
    A_eq = torch.cat([pa.A1, torch.zeros((m1, 1), dtype=dtype, device=dev)],
                     dim=1)
    b_eq = b_shift

    # --- inequality rows, all oriented as G v <= h -----------------------
    sgn = torch.where(pa.sense1 > 0, -1.0, 1.0).to(dtype)
    G_first = sgn[:, None] * A_eq
    h_first = sgn * b_shift
    m_first = ~eq_mask

    # Cut rows: (k/ns) eta + beta'd >= rhs  ->  -beta'd - (k/ns) eta <= -rhs.
    ns = torch.clamp(state.cut_ns, min=1).to(dtype)
    eta_coef = float(k) / ns
    # lb shift (updateRHS, master.c:163-188); vanishes for TRIVIAL lb = 0.
    cut_rhs = state.cut_alpha - state.cut_beta @ xbar + (eta_coef - 1.0) * pa.lb
    G_cut = torch.cat([-state.cut_beta, -eta_coef[:, None]], dim=1)
    h_cut = -cut_rhs

    # Feasibility cut rows: beta'd >= rhs -> -beta'd <= -rhs (no eta).
    f_rhs = state.fcut_alpha - state.fcut_beta @ xbar
    G_f = torch.cat([-state.fcut_beta,
                     torch.zeros((F, 1), dtype=dtype, device=dev)], dim=1)
    h_f = -f_rhs

    # Bound rows on d (infinite bounds masked off).
    lo_d = (pa.l1 if l1 is None else l1) - xbar
    up_d = (pa.u1 if u1 is None else u1) - xbar
    eye = torch.eye(n1, dtype=dtype, device=dev)
    zcol = torch.zeros((n1, 1), dtype=dtype, device=dev)
    G_up = torch.cat([eye, zcol], dim=1)
    G_lo = torch.cat([-eye, zcol], dim=1)
    up_mask = torch.isfinite(up_d)
    lo_mask = torch.isfinite(lo_d)

    # eta floor while no optimality cut is active (eta >= lb).
    G_eta = torch.zeros((1, nv), dtype=dtype, device=dev)
    G_eta[0, n1] = -1.0
    h_eta = torch.full((1,), -pa.lb, dtype=dtype, device=dev)
    eta_mask = ~torch.any(state.cut_mask)[None]

    G = torch.cat([G_first, G_cut, G_f, G_up, G_lo, G_eta], dim=0)
    h = torch.cat([h_first, h_cut, h_f,
                   torch.where(up_mask, up_d, 1.0),
                   torch.where(lo_mask, -lo_d, 1.0), h_eta])
    gmask = torch.cat([m_first, state.cut_mask, state.fcut_mask,
                       up_mask, lo_mask, eta_mask])

    res = solve_qp(Q, c, A_eq, b_eq, G, h,
                   ineq_mask=gmask, eq_mask=eq_mask, tol=tol)

    d = res.v[:n1]
    eta = res.v[n1]

    # Duals in the CPLEX minimization convention the bootstrap test expects
    # (optimal.c:240-338): >= rows positive, <= rows negative, equality rows
    # from the free eq multipliers (pi = -y).
    z = res.z
    z_first = z[:m1]
    pi_first = torch.where(eq_mask, -res.y,
                           torch.where(pa.sense1 > 0, z_first, -z_first))
    pi_cuts = z[m1:m1 + K] * state.cut_mask
    z_up = z[m1 + K + F:m1 + K + F + n1]
    z_lo = z[m1 + K + F + n1:m1 + K + F + 2 * n1]

    return MasterResult(
        x=xbar + d, eta=eta, d_norm2=d @ d,
        pi_first=pi_first, pi_cuts=pi_cuts, dj=z_lo - z_up,
        obj=res.obj, ok=res.converged, iters=res.iters,
    )


def master_lp_data(pa: ProblemArrays, state: SDState, k: int):
    """The LP master (master.c:41 with MASTER_TYPE 0) as ``solve_lp`` takes
    it: variables [x; eta],

        min  c'x + eta
        s.t. A1 x {sense} b1
             (k/ns_j) eta + beta_j'x >= alpha_j + (k/ns_j - 1) lb
             beta_f'x >= alpha_f
             l <= x <= u,  eta >= lb

    Inactive cut slots are all-zero rows with zero right-hand side.  The
    reference's LP branch is vestigial (master.c:63 reads the NULL incumbX);
    this is the JAX package's completed LP mode.  Returns (D, sense, c, lo,
    hi, b); the first n1 entries of lo and hi are the first-stage bounds."""
    dtype, dev = pa.c1.dtype, pa.c1.device
    m1 = pa.b1.shape[0]
    K = state.cut_mask.shape[0]
    F = state.fcut_mask.shape[0]
    ns = torch.clamp(state.cut_ns, min=1).to(dtype)
    eta_coef = torch.where(state.cut_mask, k / ns, 0.0)
    cut_rhs = torch.where(state.cut_mask,
                          state.cut_alpha + (k / ns - 1.0) * pa.lb, 0.0)
    cut_beta = torch.where(state.cut_mask[:, None], state.cut_beta, 0.0)
    f_beta = torch.where(state.fcut_mask[:, None], state.fcut_beta, 0.0)
    f_rhs = torch.where(state.fcut_mask, state.fcut_alpha, 0.0)

    def zcol(rows):
        return torch.zeros((rows, 1), dtype=dtype, device=dev)

    D = torch.cat([torch.cat([pa.A1, zcol(m1)], dim=1),
                   torch.cat([cut_beta, eta_coef[:, None]], dim=1),
                   torch.cat([f_beta, zcol(F)], dim=1)], dim=0)
    b = torch.cat([pa.b1, cut_rhs, f_rhs])
    sense = torch.cat([pa.sense1, torch.ones(K + F, dtype=pa.sense1.dtype,
                                             device=dev)])
    one = torch.ones(1, dtype=dtype, device=dev)
    c = torch.cat([pa.c1, one])
    lo = torch.cat([pa.l1, pa.lb * one])
    hi = torch.cat([pa.u1, math.inf * one])
    return D, sense, c, lo, hi, b


def solve_master_lp_lanes(pa: ProblemArrays, state: SDState, k: int,
                          l1=None, u1=None) -> MasterResult:
    """The LP master for W first-stage boxes at once, as the lanes of one
    ``solve_lp`` call: ``l1``/``u1`` are [W, n1] (None: the problem's own
    bounds, one lane).  Every field of the result carries the lane axis."""
    D, sense, c, lo, hi, b = master_lp_data(pa, state, k)
    n1 = pa.c1.shape[0]
    m1 = pa.b1.shape[0]
    K = state.cut_mask.shape[0]
    if l1 is None:
        lo_w, hi_w = lo[None], hi[None]
    else:
        W = l1.shape[0]
        lo_w = torch.cat([l1, lo[n1:].expand(W, -1)], dim=1)
        hi_w = torch.cat([u1, hi[n1:].expand(W, -1)], dim=1)
    W = lo_w.shape[0]
    res = solve_lp(D, sense, c.expand(W, -1), lo_w, hi_w, b.expand(W, -1),
                   max_iter=8 * (D.shape[0] + n1 + 1) + 256)
    x = res.y[:, :n1]
    d = x - state.candid_x
    # solve_lp's duals follow the CPLEX minimization convention (>= rows
    # nonnegative); the cut-row duals feed the eviction slack test.
    return MasterResult(
        x=x, eta=res.y[:, n1], d_norm2=torch.sum(d * d, dim=1),
        pi_first=res.pi[:, :m1], pi_cuts=res.pi[:, m1:m1 + K] * state.cut_mask,
        dj=res.dj[:, :n1], obj=res.obj, ok=res.status == STATUS_OPTIMAL,
        iters=res.iters)


def build_and_solve_master_lp(pa: ProblemArrays, state: SDState, k: int,
                              ) -> MasterResult:
    """The LP master (``master_lp_data``) at the problem's own bounds."""
    res = solve_master_lp_lanes(pa, state, k)
    return MasterResult(*(f[0] for f in res[:-2]), ok=bool(res.ok[0]),
                        iters=int(res.iters[0]))
