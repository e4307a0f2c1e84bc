"""Two-stage decomposition and device staging.

Equivalent of spAlgorithms ``meanProblem`` / ``calcLowerBound`` / ``newProb``
(driven from setup.c:16-64): splits the core problem at the time-file boundary
into a first-stage (master) LP and second-stage (subproblem) template with the
mean observation folded in, and derives the coordinate metadata the stochastic
updates need (the reference ``numType``/``coordType``: rvRows / CCols /
rvbOmRows / rvCOmCols / rvdOmCols / rvOffset, see subprob.c:107-110,141).

The omega vector is ordered [ b-block | C-block | d-block ] and the algorithm
works with MEAN-CENTERED observations (algo.c:148-149).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from stochasticdecomposition_torch.smps.core import CoreProblem
from stochasticdecomposition_torch.smps.stoc import (
    KIND_COST, KIND_MATRIX, KIND_RHS, StocData,
)
from stochasticdecomposition_torch.smps.timefile import TimeData


@dataclasses.dataclass
class FirstStage:
    """Master data:  min c'x  s.t.  A x {sense} b,  l <= x <= u."""

    A: np.ndarray
    b: np.ndarray
    sense: np.ndarray
    c: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    col_names: List[str]
    row_names: List[str]
    # Integrality flags (SMPS MARKER INTORG/INTEND + BV bounds).  Drives the
    # MILP/MIQP master modes (MASTER_TYPE 1/7, reference config.sd:10-11 —
    # the reference passes the type straight to CPLEX at master.c:41).
    is_int: Optional[np.ndarray] = None


@dataclasses.dataclass
class SecondStage:
    """Subproblem template:
        h(x, w) = min (d_bar + d_w)'y
                  s.t. D y {sense} (b_bar + b_w) - (C_bar + C_w) x,
                       l <= y <= u
    with the random parts b_w/C_w/d_w scattered from the centered omega vector.
    """

    D: np.ndarray             # [m2, n2]
    b_bar: np.ndarray         # [m2] (means folded in)
    sense: np.ndarray         # [m2]
    C_bar: np.ndarray         # [m2, n1] (means folded in)
    d_bar: np.ndarray         # [n2] (means folded in)
    lb: np.ndarray
    ub: np.ndarray
    col_names: List[str]
    row_names: List[str]


@dataclasses.dataclass
class RVCoords:
    """Randomness coordinates (reference numType/coordType equivalents)."""

    num_rv: int               # total RVs = nb + nC + nd
    rv_b_rows: np.ndarray     # [nb] subproblem row of each b-block RV
    rv_C_rows: np.ndarray     # [nC] subproblem row of each C-block RV
    rv_C_cols: np.ndarray     # [nC] first-stage col of each C-block RV
    rv_d_cols: np.ndarray     # [nd] subproblem col of each d-block RV
    omega_mean: np.ndarray    # [num_rv] distribution means (centering vector)
    # Derived:
    lambda_rows: np.ndarray   # rows with any randomness (lambda sub-vector,
    #                           reference coord->rvRows / num->rvRowCnt)
    C_cols: np.ndarray        # first-stage cols with nonzero C_bar or random C
    #                           (reference coord->CCols / num->cntCcols)

    @property
    def nb(self):
        return len(self.rv_b_rows)

    @property
    def nC(self):
        return len(self.rv_C_rows)

    @property
    def nd(self):
        return len(self.rv_d_cols)

    # rvOffset equivalents (subprob.c:107-110,141).
    @property
    def off_b(self):
        return 0

    @property
    def off_C(self):
        return self.nb

    @property
    def off_d(self):
        return self.nb + self.nC


@dataclasses.dataclass
class StagedProblem:
    name: str
    first: FirstStage
    second: SecondStage
    rv: RVCoords
    lb: float                 # lower bound on E[h(x, omega)] (calcLowerBound)
    lb_is_trivial: bool       # TRIVIAL (lb == 0) vs NONTRIVIAL (twoSD.h:21-22)
    rv_order: np.ndarray      # parse-order -> omega-position permutation


def decompose(core: CoreProblem, tim: TimeData, stoc: StocData) -> StagedProblem:
    """Split core at the stage boundary and fold means into the templates."""
    r1 = tim.row_starts[1]
    c1 = tim.col_starts[1]
    m1, n1 = r1, c1
    m2 = core.n_rows - r1
    n2 = core.n_cols - c1

    first = FirstStage(
        A=core.A[:r1, :c1].copy(),
        b=core.b[:r1].copy(),
        sense=core.sense[:r1].copy(),
        c=core.c[:c1].copy(),
        lb=core.lb[:c1].copy(),
        ub=core.ub[:c1].copy(),
        col_names=core.col_names[:c1],
        row_names=core.row_names[:r1],
        is_int=core.is_integer[:c1].copy(),
    )
    if np.any(core.is_integer[c1:]):
        # SD requires continuous recourse (the subproblem dual vertices ARE
        # the algorithm); integer second-stage variables have no dual
        # machinery in the reference either.
        raise ValueError(
            "integer second-stage variables are not supported: SD requires "
            "continuous recourse (duals drive the cut machinery)")
    if np.any(core.A[:r1, c1:] != 0):
        if any(row < r1 for row, _ in getattr(core, "range_slacks", [])):
            # RANGES slacks are appended after the structural columns
            # (smps/core.py _apply_ranges), which places them in the second
            # stage; a ranged FIRST-stage row therefore cannot be staged.
            raise NotImplementedError(
                "RANGES on first-stage rows are not supported (the range "
                "slack column falls outside the first-stage column block)")
        raise ValueError("second-stage variables appear in first-stage rows")
    if np.any(core.c[c1:] != 0):
        # Second-stage costs live in the subproblem objective d, not in c;
        # the core objective row holds both, split here.
        pass

    second = SecondStage(
        D=core.A[r1:, c1:].copy(),
        b_bar=core.b[r1:].copy(),
        sense=core.sense[r1:].copy(),
        C_bar=core.A[r1:, :c1].copy(),
        d_bar=core.c[c1:].copy(),
        lb=core.lb[c1:].copy(),
        ub=core.ub[c1:].copy(),
        col_names=core.col_names[c1:],
        row_names=core.row_names[r1:],
    )

    # ---- classify random elements into the [b | C | d] blocks -----------
    b_elems, C_elems, d_elems = [], [], []
    for i, el in enumerate(stoc.elements):
        if el.kind == KIND_RHS:
            if el.row < r1:
                raise NotImplementedError("randomness in first-stage RHS")
            b_elems.append(i)
        elif el.kind == KIND_MATRIX:
            if el.row < r1:
                raise NotImplementedError("randomness in first-stage rows")
            if el.col >= c1:
                raise NotImplementedError(
                    "randomness in the recourse matrix D is not supported "
                    "(matches the reference scope: b, C and d only)")
            C_elems.append(i)
        elif el.kind == KIND_COST:
            if el.col < c1:
                raise NotImplementedError("randomness in first-stage costs")
            d_elems.append(i)
        else:
            raise ValueError(el.kind)

    order = b_elems + C_elems + d_elems
    rv_order = np.zeros(len(stoc.elements), np.int32)
    for pos, i in enumerate(order):
        rv_order[i] = pos

    means_parse = stoc.means()
    omega_mean = means_parse[np.array(order, int)] if order else np.zeros(0)

    rv_b_rows = np.array([stoc.elements[i].row - r1 for i in b_elems], np.int32)
    rv_C_rows = np.array([stoc.elements[i].row - r1 for i in C_elems], np.int32)
    rv_C_cols = np.array([stoc.elements[i].col for i in C_elems], np.int32)
    rv_d_cols = np.array([stoc.elements[i].col - c1 for i in d_elems], np.int32)

    # ---- fold means into the templates (meanProblem, setup.c:21) --------
    for k, i in enumerate(b_elems):
        second.b_bar[rv_b_rows[k]] = means_parse[i]
    for k, i in enumerate(C_elems):
        second.C_bar[rv_C_rows[k], rv_C_cols[k]] = means_parse[i]
    for k, i in enumerate(d_elems):
        second.d_bar[rv_d_cols[k]] = means_parse[i]

    # ---- derived coordinates --------------------------------------------
    lambda_rows = np.unique(np.concatenate([rv_b_rows, rv_C_rows])) \
        if (len(rv_b_rows) + len(rv_C_rows)) else np.zeros(0, np.int32)
    nz_cols = np.where(np.any(second.C_bar != 0, axis=0))[0]
    C_cols = np.unique(np.concatenate([nz_cols, rv_C_cols])) \
        if len(rv_C_cols) else nz_cols
    rv = RVCoords(
        num_rv=len(stoc.elements),
        rv_b_rows=rv_b_rows, rv_C_rows=rv_C_rows, rv_C_cols=rv_C_cols,
        rv_d_cols=rv_d_cols, omega_mean=omega_mean,
        lambda_rows=lambda_rows.astype(np.int32),
        C_cols=C_cols.astype(np.int32),
    )

    # Minimum possible cost per second-stage column (for the lower bound).
    d_min = second.d_bar.copy()
    for kk, i in enumerate(d_elems):
        d_min[rv_d_cols[kk]] = _dist_min(stoc, i)
    lb, trivial = _calc_lower_bound(second, rv, d_min)

    return StagedProblem(
        name=core.name, first=first, second=second, rv=rv,
        lb=lb, lb_is_trivial=trivial, rv_order=rv_order,
    )


def _dist_min(stoc: StocData, elem_idx: int) -> float:
    """Minimum possible value of a random element (support lower edge)."""
    from stochasticdecomposition_torch.smps.stoc import (
        DIST_BLOCK, DIST_DISCRETE, DIST_NORMAL, DIST_UNIFORM,
    )

    el = stoc.elements[elem_idx]
    if el.dist == DIST_DISCRETE:
        return float(np.min(el.values))
    if el.dist == DIST_UNIFORM:
        return el.p1
    if el.dist == DIST_NORMAL:
        return el.p1 - 10.0 * np.sqrt(max(el.p2, 0.0))
    if el.dist == DIST_BLOCK:
        blk = stoc.blocks[el.block_id]
        pos = blk.elem_indices.index(elem_idx)
        return float(np.min(blk.outcomes[:, pos]))
    raise ValueError(el.dist)


def _calc_lower_bound(second: SecondStage, rv: RVCoords, d_min: np.ndarray):
    """Lower bound on h(x, omega) over all x, omega (calcLowerBound equiv).

    If the worst-case subproblem cost d_min is nonnegative and y >= 0 then
    h >= 0 (TRIVIAL) — this covers the classical benchmark family.
    Otherwise weak duality with pi = 0 gives
        h(x, w) >= sum_j min(0, d_min_j) * u_j
    over finite boxes, which requires negative-cost columns to be bounded
    above; else the user must supply SDConfig.LOWER_BOUND.
    """
    if np.all(d_min >= 0) and np.all(second.lb >= 0):
        return 0.0, True
    ub = np.where(np.isfinite(second.ub), second.ub, 0.0)
    lo_contrib = np.minimum(0.0, d_min) * ub
    neg_free = (d_min < 0) & ~np.isfinite(second.ub)
    if np.any(neg_free):
        raise ValueError(
            "cannot derive a finite lower bound for a subproblem with "
            "negative-cost unbounded variables; set SDConfig.LOWER_BOUND")
    lb = float(np.sum(lo_contrib))
    return lb, lb == 0.0


def attach_stoc(sp: StagedProblem, stoc: StocData) -> StagedProblem:
    """Keep the parsed stoch data on the staged problem for the sampler."""
    sp._stoc = stoc
    return sp
