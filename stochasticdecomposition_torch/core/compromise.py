"""Compromise problem: the decision of several replications together.

Reference: compromise.c.  After the replications finish, their first-stage
copies are tied together by equality constraints (addBatchEquality,
compromise.c:285-311) and the cut collections of every replication act on one
common decision; one QP with the averaged proximal weight is solved
(solveCompromise, compromise.c:249-283).

The port of the JAX package's ``core/compromise.py``: the batch QP is one
block-structured dense problem, built here with block-diagonal tensor
operations in the JAX package's row order, and solved by the port's IPM
(``ops/qp.py``) in f64 on the device the problem is staged on.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from stochasticdecomposition_torch.core.bnb import (
    INT_TOL, MAX_NODES, PRUNE_EPS,
)
from stochasticdecomposition_torch.core.state import ProblemArrays
from stochasticdecomposition_torch.ops.qp import solve_qp


@dataclasses.dataclass
class BatchEntry:
    """Per-replication artifacts collected by buildCompromise
    (compromise.c:16-47 / batchSummary, twoSD.h:151-162), on the host."""

    incumb_x: np.ndarray
    k: int
    quad_scalar: float
    obj_lb: float
    cut_alpha: np.ndarray     # [K]
    cut_beta: np.ndarray      # [K, n1]
    cut_ns: np.ndarray        # [K]
    cut_mask: np.ndarray      # [K] bool
    fcut_alpha: np.ndarray    # [F]
    fcut_beta: np.ndarray     # [F, n1]
    fcut_mask: np.ndarray     # [F] bool


def _host(t: torch.Tensor) -> np.ndarray:
    # A copy: the state's pools are updated in place, and on the CPU
    # ``numpy()`` would be a view of them.
    return t.detach().cpu().numpy().copy()


def batch_entry_from_state(state) -> BatchEntry:
    return BatchEntry(
        incumb_x=_host(state.incumb_x),
        k=int(state.k),
        quad_scalar=float(state.quad_scalar),
        obj_lb=float(state.incumb_est),
        cut_alpha=_host(state.cut_alpha),
        cut_beta=_host(state.cut_beta),
        cut_ns=_host(state.cut_ns),
        cut_mask=_host(state.cut_mask),
        fcut_alpha=_host(state.fcut_alpha),
        fcut_beta=_host(state.fcut_beta),
        fcut_mask=_host(state.fcut_mask),
    )


def _replication_block(pa: ProblemArrays, e: BatchEntry, lo, hi, lb: float):
    """The rows of one replication's block [d_b; eta_b] (width n1 + 1):
    (G_b, h_b) and (A_b, b_b), in the JAX package's order — first-stage
    inequalities, optimality cuts, feasibility cuts, the bounds of each
    column (upper then lower), eta_b >= lb."""
    dtype, dev = pa.c1.dtype, pa.c1.device
    n1 = pa.c1.shape[0]

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    def with_eta(rows, eta):
        return torch.cat([rows, eta[:, None]], dim=1)

    xbar = t(e.incumb_x)
    shift = pa.b1 - pa.A1 @ xbar
    # First-stage rows shifted to d = x - xbar; >= rows negated to <=.
    eq = pa.sense1 == 0
    sign = torch.where(pa.sense1 > 0, -1.0, 1.0).to(dtype)
    ineq = ~eq
    g_first = sign[ineq][:, None] * pa.A1[ineq]
    h_first = (sign * shift)[ineq]
    # Optimality cuts: (k_b/ns) eta_b + beta'd_b >= rhs.
    cm = t(e.cut_mask, torch.bool)
    beta = t(e.cut_beta)[cm]
    ns = torch.clamp(t(e.cut_ns, torch.int64)[cm], min=1).to(dtype)
    coef = float(e.k) / ns
    rhs = t(e.cut_alpha)[cm] - beta @ xbar + (coef - 1.0) * lb
    # Feasibility cuts: beta'd_b >= alpha - beta'xbar.
    fm = t(e.fcut_mask, torch.bool)
    fbeta = t(e.fcut_beta)[fm]
    frhs = t(e.fcut_alpha)[fm] - fbeta @ xbar
    # Bounds on d_b, upper then lower for each column, finite ones only.
    eye = torch.eye(n1, dtype=dtype, device=dev)
    bound_rows = torch.stack([eye, -eye], dim=1)                # [n1, 2, n1]
    bound_h = torch.stack([hi - xbar, -(lo - xbar)], dim=1)     # [n1, 2]
    finite = torch.stack([torch.isfinite(hi), torch.isfinite(lo)], dim=1)

    def zeros(m):
        return torch.zeros(m, dtype=dtype, device=dev)

    G = torch.cat([
        with_eta(g_first, zeros(g_first.shape[0])),
        with_eta(-beta, -coef),
        with_eta(-fbeta, zeros(fbeta.shape[0])),
        with_eta(bound_rows[finite], zeros(int(finite.sum()))),
        with_eta(zeros((1, n1)), -torch.ones(1, dtype=dtype, device=dev)),
    ])
    h = torch.cat([h_first, -rhs, -frhs, bound_h[finite],
                   torch.full((1,), -lb, dtype=dtype, device=dev)])
    A = with_eta(pa.A1[eq], zeros(int(eq.sum())))
    return G, h, A, shift[eq]


def solve_compromise(pa: ProblemArrays, entries: List[BatchEntry], *,
                     x_lo=None, x_hi=None, _return_obj: bool = False):
    """Returns (compromise_x, avg_x) as numpy arrays.

    Variables: per replication b, a block [d_b (n1); eta_b].  Objective
    sum_b c'd_b + eta_b + (sigma_bar/2)||d_b||^2 with sigma_bar the averaged
    proximal scalar (compromise.c:216-224).  eta_b >= lb (compromise.c:121).
    The copies are tied by d_0 - d_b = xbar_b - xbar_0 (compromise.c:285-300).

    ``x_lo``/``x_hi`` override the first-stage variable bounds (applied to
    every replication block — the equality ties make the copies one
    decision); the integer compromise below branches on them.  With
    ``_return_obj`` the result is (x, objective, converged), and an
    unconverged solve is reported instead of raised.
    """
    dtype, dev = pa.c1.dtype, pa.c1.device
    B = len(entries)
    n1 = pa.c1.shape[0]
    blk = n1 + 1
    nv = B * blk
    lb = float(pa.lb)
    lo = pa.l1 if x_lo is None else torch.as_tensor(
        np.asarray(x_lo), dtype=dtype, device=dev)
    hi = pa.u1 if x_hi is None else torch.as_tensor(
        np.asarray(x_hi), dtype=dtype, device=dev)
    sigma_bar = float(np.mean([e.quad_scalar for e in entries]))

    q = torch.full((blk,), sigma_bar, dtype=dtype, device=dev)
    q[n1] = 0.0
    Q = torch.diag(q.repeat(B))
    c = torch.cat([pa.c1, torch.ones(1, dtype=dtype, device=dev)]).repeat(B)

    blocks = [_replication_block(pa, e, lo, hi, lb) for e in entries]
    G = torch.block_diag(*(g for g, _, _, _ in blocks))
    h = torch.cat([hb for _, hb, _, _ in blocks])
    # Equality ties: row (b - 1) * n1 + j is d_0[j] - d_b[j].
    x0 = entries[0].incumb_x
    rows = torch.arange((B - 1) * n1, device=dev)
    ties = torch.zeros(((B - 1) * n1, nv), dtype=dtype, device=dev)
    ties[rows, rows % n1] = 1.0
    ties[rows, (rows // n1 + 1) * blk + rows % n1] = -1.0
    tie_rhs = torch.as_tensor(
        np.concatenate([e.incumb_x - x0 for e in entries[1:]] + [[]]),
        dtype=dtype, device=dev)
    A = torch.cat([torch.block_diag(*(a for _, _, a, _ in blocks)), ties])
    b = torch.cat([bb for _, _, _, bb in blocks] + [tie_rhs])

    res = solve_qp(Q, c, A, b, G, h,
                   polish=(nv + A.shape[0] + G.shape[0]) <= 2000,
                   max_iter=100, consistent_clamp=True)
    d0 = res.v[:n1].cpu().numpy()
    if _return_obj:
        # B&B node mode: report (x, obj, ok) and let the caller prune — a
        # non-certified node on a tightened box is (almost always) an
        # infeasible box, not an error.
        return x0 + d0, float(res.obj), bool(res.converged)
    if not bool(res.converged):
        raise RuntimeError("compromise QP failed to converge")
    avg_x = np.mean([e.incumb_x for e in entries], axis=0)
    return x0 + d0, avg_x


def solve_compromise_mip(pa: ProblemArrays, entries: List[BatchEntry]):
    """Integer-mode compromise (MASTER_TYPE 1/7): the reference solves the
    batch problem with the configured master type (compromise.c:260).
    Best-first branch-and-bound on the common decision x = x0 + d0 over the
    continuous batch-QP relaxation above, as the JAX package's: nodes sorted
    by bound, an uncertified node retried once, branching on the most
    fractional flagged column.  Returns (compromise_x, avg_x) with
    ``compromise_x`` integral on the flagged columns; ``avg_x`` is the plain
    replication average (fractional by nature, reported as-is like the
    reference's batch average)."""
    int_idx = np.where(pa.int1.cpu().numpy())[0]
    lo = pa.l1.cpu().numpy().copy()
    hi = pa.u1.cpu().numpy().copy()
    lo[int_idx] = np.ceil(lo[int_idx] - INT_TOL)
    hi[int_idx] = np.floor(hi[int_idx] + INT_TOL)

    open_nodes = [(-np.inf, lo, hi, 0)]
    best_obj, best_x = np.inf, None
    nodes = 0
    uncertified = 0
    while open_nodes and nodes < MAX_NODES:
        open_nodes.sort(key=lambda t: t[0])
        bound, lo_n, hi_n, tries = open_nodes.pop(0)
        if bound >= best_obj - PRUNE_EPS:
            continue
        nodes += 1
        x, obj, ok = solve_compromise(pa, entries, x_lo=lo_n, x_hi=hi_n,
                                      _return_obj=True)
        if not ok:
            # An unconverged batch QP is not proof the box is integer-
            # infeasible: retry the node once; only a repeat failure prunes,
            # and is counted for the terminal diagnostic.
            if tries == 0:
                open_nodes.append((bound, lo_n, hi_n, 1))
            else:
                uncertified += 1
            continue
        if obj >= best_obj - PRUNE_EPS:
            continue
        frac = np.abs(x[int_idx] - np.round(x[int_idx]))
        j_rel = int(np.argmax(frac)) if int_idx.size else 0
        if int_idx.size == 0 or frac[j_rel] <= INT_TOL:
            xi = x.copy()
            xi[int_idx] = np.round(xi[int_idx])
            best_obj, best_x = obj, xi
            continue
        j = int(int_idx[j_rel])
        dn = hi_n.copy()
        dn[j] = np.floor(x[j])
        up = lo_n.copy()
        up[j] = np.ceil(x[j])
        if dn[j] >= lo_n[j] - INT_TOL:
            open_nodes.append((obj, lo_n.copy(), dn, 0))
        if up[j] <= hi_n[j] + INT_TOL:
            open_nodes.append((obj, up, hi_n.copy(), 0))

    if best_x is None:
        if uncertified:
            raise RuntimeError(
                f"integer compromise: batch-QP relaxations failed to "
                f"converge ({uncertified} of {nodes} nodes uncertified "
                "after retry) — not proof of integer infeasibility")
        raise RuntimeError(
            f"integer compromise: no integer-feasible point found "
            f"({nodes} nodes explored)")
    avg_x = np.mean([e.incumb_x for e in entries], axis=0)
    return best_x, avg_x
