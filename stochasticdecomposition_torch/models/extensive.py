"""Extensive-form (deterministic-equivalent) oracle.

Builds the single LP over all scenarios of a finite-support 2-SLP and solves
it with the framework's own simplex kernel.  This is the end-to-end parity
oracle the tests use (the reference has no test suite; its de-facto oracle is
the STOCH_CHECK re-solve block at cuts.c:64-76 — see tests/test_sdcut.py for
that property; this module provides the objective-parity companion).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from stochasticdecomposition_torch.prob import StagedProblem
from stochasticdecomposition_torch.smps.stoc import DIST_BLOCK, DIST_DISCRETE, StocData


def enumerate_scenarios(stoc: StocData, rv_order: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """All joint outcomes of a finite-support stoch file.

    Returns (outcomes [S, num_rv] in omega order, probs [S]).  Raises for
    continuous distributions.
    """
    axes = []           # list of (positions [k], outcome_values [n_i, k], probs [n_i])
    seen_blocks = set()
    for i, el in enumerate(stoc.elements):
        pos = int(rv_order[i])
        if el.dist == DIST_DISCRETE:
            axes.append((np.array([pos]), el.values[:, None], el.probs))
        elif el.dist == DIST_BLOCK:
            if el.block_id in seen_blocks:
                continue
            seen_blocks.add(el.block_id)
            blk = stoc.blocks[el.block_id]
            positions = rv_order[np.asarray(blk.elem_indices)]
            axes.append((positions, blk.outcomes, blk.probs))
        else:
            raise ValueError(
                f"extensive form needs finite support, got {el.dist}")

    num_rv = len(stoc.elements)
    outs, probs = [], []
    for combo in itertools.product(*[range(len(a[2])) for a in axes]):
        w = np.zeros(num_rv)
        p = 1.0
        for (positions, table, pr), k in zip(axes, combo):
            w[positions] = table[k]
            p *= pr[k]
        outs.append(w)
        probs.append(p)
    return np.array(outs), np.array(probs)


def scenario_count(stoc: StocData) -> int:
    """Joint-support size without enumerating (to gate enumeration cost)."""
    n = 1
    seen_blocks = set()
    for el in stoc.elements:
        if el.dist == DIST_DISCRETE:
            n *= len(el.probs)
        elif el.dist == DIST_BLOCK:
            if el.block_id not in seen_blocks:
                seen_blocks.add(el.block_id)
                n *= len(stoc.blocks[el.block_id].probs)
        else:
            return -1           # continuous: not enumerable
    return n


def exact_objective_fn(pa, outs: np.ndarray, probs: np.ndarray):
    """x -> c'x + E[h(x, omega)] by FULL scenario enumeration.

    Zero sampling error, so parity gaps vs the extensive-form optimum are
    exact.  All scenario subproblems are solved as the lanes of one
    ``solve_lp`` call on the problem's device."""
    import torch

    from stochasticdecomposition_torch.core.update import (
        subproblem_rhs_cost_lanes,
    )
    from stochasticdecomposition_torch.ops.simplex import (
        STATUS_OPTIMAL, solve_lp,
    )

    dtype, dev = pa.c1.dtype, pa.c1.device
    W = torch.as_tensor(outs, dtype=dtype, device=dev) - pa.omega_mean[None]
    p = torch.as_tensor(probs, dtype=dtype, device=dev)

    def obj(x) -> float:
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        rhs, cost = subproblem_rhs_cost_lanes(pa, x, W)
        res = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs)
        if not bool(torch.all(res.status == STATUS_OPTIMAL)):
            raise RuntimeError("a scenario subproblem was not solved to "
                               "optimality")
        return float(pa.c1 @ x + p @ res.obj)

    return obj


def solve_extensive_form(sp: StagedProblem, outcomes: np.ndarray,
                         probs: np.ndarray, backend: str = "scipy"):
    """Solve the deterministic equivalent; returns (objective, x)."""
    f, s, rv = sp.first, sp.second, sp.rv
    m1, n1 = f.A.shape
    m2, n2 = s.D.shape
    S = len(probs)

    # Scenario data: centered omega applied on top of the mean templates.
    centered = outcomes - rv.omega_mean[None, :]
    nb, nC, nd = rv.nb, rv.nC, rv.nd

    n_tot = n1 + S * n2
    m_tot = m1 + S * m2
    A = np.zeros((m_tot, n_tot))
    b = np.zeros(m_tot)
    sense = np.zeros(m_tot, np.int32)
    c = np.zeros(n_tot)
    lo = np.zeros(n_tot)
    hi = np.zeros(n_tot)

    A[:m1, :n1] = f.A
    b[:m1] = f.b
    sense[:m1] = f.sense
    c[:n1] = f.c
    lo[:n1], hi[:n1] = f.lb, f.ub

    for si in range(S):
        w = centered[si]
        C_s = s.C_bar.copy()
        if nC:
            C_s[rv.rv_C_rows, rv.rv_C_cols] += w[rv.off_C:rv.off_C + nC]
        b_s = s.b_bar.copy()
        if nb:
            b_s[rv.rv_b_rows] += w[:nb]
        d_s = s.d_bar.copy()
        if nd:
            d_s[rv.rv_d_cols] += w[rv.off_d:rv.off_d + nd]

        r0 = m1 + si * m2
        cc = n1 + si * n2
        A[r0:r0 + m2, :n1] = C_s
        A[r0:r0 + m2, cc:cc + n2] = s.D
        b[r0:r0 + m2] = b_s
        sense[r0:r0 + m2] = s.sense
        c[cc:cc + n2] = probs[si] * d_s
        lo[cc:cc + n2], hi[cc:cc + n2] = s.lb, s.ub

    if backend == "scipy":
        from scipy.optimize import linprog

        ub_rows = sense == -1
        ge_rows = sense == 1
        eq_rows = sense == 0
        A_ub = np.vstack([A[ub_rows], -A[ge_rows]])
        b_ub = np.concatenate([b[ub_rows], -b[ge_rows]])
        res = linprog(c, A_ub=A_ub if len(A_ub) else None,
                      b_ub=b_ub if len(b_ub) else None,
                      A_eq=A[eq_rows] if eq_rows.any() else None,
                      b_eq=b[eq_rows] if eq_rows.any() else None,
                      bounds=list(zip(lo, hi)), method="highs")
        if res.status != 0:
            raise RuntimeError(f"extensive form LP failed: {res.message}")
        return float(res.fun), np.array(res.x[:n1])

    # Own-kernel path (cross-validates the simplex end to end), on the CPU.
    import torch

    from stochasticdecomposition_torch.ops.simplex import (
        STATUS_OPTIMAL, lane, solve_lp,
    )

    def t(a, dt=torch.float64):
        return torch.as_tensor(a, dtype=dt)

    out = lane(solve_lp(t(A), t(sense, torch.int64), t(c)[None], t(lo),
                        t(hi), t(b)[None]), 0)
    if int(out.status) != STATUS_OPTIMAL:
        raise RuntimeError(f"extensive form LP status {int(out.status)}")
    return float(out.obj), out.y[:n1].numpy()
