"""Branch-and-bound MILP/MIQP master (MASTER_TYPE 1 and 7).

The reference hands the master to CPLEX with the configured problem type
(master.c:41 ``solveProblem(..., config.MASTER_TYPE, ...)``; master.c:331
"type of problem: LP, QP, MIP or MIQP"; config.sd:10-11) and lets CPLEX
enforce first-stage integrality.  The port of the JAX package's
``core/bnb.py``: a host-driven best-first branch-and-bound over the LP or QP
master relaxations, in waves of up to WAVE open nodes.  A wave's LP
relaxations are the lanes of one ``solve_lp`` call; its QP relaxations are
solved one after another.  The tree is the JAX package's: the same waves,
the same pruning, the same node count.

Correctness invariants:
  * a node's relaxation objective lower-bounds every integer-feasible point
    in its box (tightening bounds only shrinks the feasible set), so pruning
    on ``relax_obj >= best - eps`` is exact;
  * branching on x_j splits the box into floor/ceil halves that cover every
    integer value, so no integer point is lost;
  * the proximal term of the MIQP master is convex, which is all the bound
    argument needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stochasticdecomposition_torch.config import MASTER_MIQP, SDConfig
from stochasticdecomposition_torch.core.master import (
    build_and_solve_master, solve_master_lp_lanes,
)
from stochasticdecomposition_torch.core.state import ProblemArrays, SDState

INT_TOL = 1e-6          # integrality tolerance on relaxation solutions
PRUNE_EPS = 1e-9        # bound-pruning slack
WAVE = 8                # open nodes whose relaxations are solved together
MAX_NODES = 2048        # node limit per master solve


class MIPResult(NamedTuple):
    x: Optional[np.ndarray]   # best integral solution (rounded), or None
    obj: float                # master objective at x
    found: bool               # an integral solution was certified
    nodes: int                # nodes expanded
    waves: int                # waves of relaxations solved
    # The node limit was hit with open nodes left: x may be suboptimal.
    truncated: bool
    # Nodes pruned because their relaxation failed to certify twice
    # (distinct from integer-infeasible boxes).
    uncertified: int


def make_mip_master(pa: ProblemArrays, cfg: SDConfig):
    """The branch-and-bound master for this problem: ``solve(state) ->
    MIPResult``, integrality on the columns flagged in ``pa.int1``."""
    int_idx = np.where(pa.int1.cpu().numpy())[0]
    if int_idx.size == 0:
        raise ValueError("make_mip_master on a problem with no integer "
                         "first-stage columns")
    qp = cfg.MASTER_TYPE == MASTER_MIQP
    dtype, dev = pa.c1.dtype, pa.c1.device

    def _solve_wave(state: SDState, lo_b, hi_b):
        """The relaxations of W boxes: (x [W, n1], obj [W], ok [W])."""
        lo = torch.as_tensor(lo_b, dtype=dtype, device=dev)
        hi = torch.as_tensor(hi_b, dtype=dtype, device=dev)
        if qp:
            rs = [build_and_solve_master(pa, state, state.k, l1=lo[w],
                                         u1=hi[w]) for w in range(lo.shape[0])]
            xs = torch.stack([r.x for r in rs])
            objs = torch.stack([r.obj for r in rs])
            oks = np.array([bool(r.ok) for r in rs])
        else:
            r = solve_master_lp_lanes(pa, state, state.k, l1=lo, u1=hi)
            xs, objs, oks = r.x, r.obj, r.ok.cpu().numpy()
        return (xs.cpu().numpy().astype(np.float64),
                objs.cpu().numpy().astype(np.float64), oks)

    # Root box: the problem bounds with integer columns tightened to their
    # integer hull (ceil of lb, floor of ub).
    l_root = pa.l1.cpu().numpy().astype(np.float64)
    u_root = pa.u1.cpu().numpy().astype(np.float64)
    l_root[int_idx] = np.ceil(l_root[int_idx] - INT_TOL)
    u_root[int_idx] = np.floor(u_root[int_idx] + INT_TOL)

    def solve(state: SDState) -> MIPResult:
        # Open nodes (bound, lo, hi, tries); bound = the parent relaxation's
        # objective (-inf at the root).  Best-first: a wave takes the
        # lowest bounds.
        open_nodes = [(-np.inf, l_root.copy(), u_root.copy(), 0)]
        best_obj = np.inf
        best_x = None
        nodes = waves = uncertified = 0

        while open_nodes and nodes < MAX_NODES:
            open_nodes.sort(key=lambda t: t[0])
            take = open_nodes[:WAVE]
            open_nodes = open_nodes[WAVE:]
            # Prune by bound before paying for the solve.
            take = [t for t in take if t[0] < best_obj - PRUNE_EPS]
            if not take:
                continue
            xs, objs, oks = _solve_wave(state, np.stack([t[1] for t in take]),
                                        np.stack([t[2] for t in take]))
            waves += 1
            for w, (bound, lo_w, hi_w, tries) in enumerate(take):
                nodes += 1
                if not oks[w]:
                    # An uncertified relaxation: usually an infeasible box.
                    # Re-enqueue once; a second failure prunes the node and
                    # is counted apart from integer infeasibility.
                    if tries == 0:
                        open_nodes.append((bound, lo_w, hi_w, 1))
                    else:
                        uncertified += 1
                    continue
                if objs[w] >= best_obj - PRUNE_EPS:
                    continue
                x = xs[w]
                frac = np.abs(x[int_idx] - np.round(x[int_idx]))
                j_rel = int(np.argmax(frac))
                if frac[j_rel] <= INT_TOL:
                    x_int = x.copy()
                    x_int[int_idx] = np.round(x_int[int_idx])
                    best_obj = float(objs[w])
                    best_x = x_int
                    continue
                j = int(int_idx[j_rel])
                dn_hi = hi_w.copy()
                dn_hi[j] = np.floor(x[j])
                up_lo = lo_w.copy()
                up_lo[j] = np.ceil(x[j])
                if dn_hi[j] >= lo_w[j] - INT_TOL:
                    open_nodes.append((float(objs[w]), lo_w.copy(), dn_hi, 0))
                if up_lo[j] <= hi_w[j] + INT_TOL:
                    open_nodes.append((float(objs[w]), up_lo, hi_w.copy(), 0))

        truncated = bool(open_nodes) and nodes >= MAX_NODES
        return MIPResult(best_x, best_obj, best_x is not None, nodes, waves,
                         truncated, uncertified)

    return solve
