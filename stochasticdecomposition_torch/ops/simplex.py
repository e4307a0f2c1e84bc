"""Bounded-variable revised simplex over a leading lane axis, in PyTorch.

The port of the JAX package's ``ops/simplex.py::solve_lp``, the replacement
for the CPLEX primal-simplex calls of the reference (subprob.c:43-45).  Every
SD subproblem solve needs the optimal *basis* — duals, reduced costs, column
status — because the stochastic updates (stocUpdate.c:14-133) consume them.

The algorithm is the JAX package's, step for step:
  * the LP  min c'y  s.t. D y {<=,=,>=} b, l<=y<=u  in the computational
    standard form  A z = b, lo<=z<=up  with A = [D | I] (slack bounds encode
    the row sense);
  * composite phase 1 (infeasible basics priced by the infeasibility
    gradient and blocking at the bound they violate), Devex pricing, a
    Bland fallback after ``stall_limit`` degenerate pivots, and a Harris
    two-pass ratio test;
  * product-form updates of an explicit basis inverse with a refactorization
    every ``chunk`` pivots, the iteration cap tested only at those chunk
    boundaries (as the JAX loop tests it);
  * warm start from a given basis, and a Farkas ray for infeasible LPs.

Lanes are solved in lockstep with per-lane done masks; a lane that is done
(or past its cap at a chunk boundary) keeps its state.  The loop leaves as
soon as every lane is done, which changes nothing: the JAX loop's remaining
masked pivots leave finished lanes as they are.

A lane's path does not depend on how many lanes run with it.  A degenerate
LP can tie in the Devex pricing exactly, and then the last bit of a pricing
product picks the entering column; but a BLAS product of [B, m] rows by a
shared [m, n] matrix takes another kernel, and other bits, at another B
(a GEMV at B = 1, a GEMM above; on the card cuBLAS picks by shape).  So
the lanes are padded to whole groups of ``lane_group`` lanes, and every
product of the lanes (and on the card the refactorization) runs as one call
of that fixed shape per group: lane i is always row i mod G of a call of the
same shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stochasticdecomposition_torch.ops.linalg import refactorize

# Column / row status codes (mirror CPLEX's CPX_AT_LOWER etc.).
AT_LOWER = 0
BASIC = 1
AT_UPPER = 2
FREE_NB = 3

STATUS_OPTIMAL = 0
STATUS_INFEASIBLE = 1
STATUS_UNBOUNDED = 2
STATUS_ITER_LIMIT = 3

_INF = float("inf")


class LPResult(NamedTuple):
    """Each field carries the leading lane axis."""

    status: torch.Tensor      # [B] int64
    obj: torch.Tensor         # [B] objective value (c'y)
    y: torch.Tensor           # [B, n] primal solution (structural)
    pi: torch.Tensor          # [B, m] row duals; GE rows >= 0, LE rows <= 0
    dj: torch.Tensor          # [B, n] reduced costs of structural columns
    cstat: torch.Tensor       # [B, n] column status
    rstat: torch.Tensor       # [B, m] slack status
    basis: torch.Tensor       # [B, m] basic variable index per row
    binv: torch.Tensor        # [B, m, m] basis inverse
    iters: torch.Tensor       # [B] iterations used
    farkas: torch.Tensor      # [B, m] dual ray when infeasible, else zeros


def lane(res: LPResult, i: int) -> LPResult:
    """The result of lane ``i`` alone (fields without the lane axis)."""
    return LPResult(*(f[i] for f in res))


class _State(NamedTuple):
    basis: torch.Tensor       # [B, m] int64
    in_basis: torch.Tensor    # [B, nt] bool
    at_upper: torch.Tensor    # [B, nt] bool (meaningful for nonbasic only)
    binv: torch.Tensor        # [B, m, m]
    xb: torch.Tensor          # [B, m] basic values
    gamma: torch.Tensor       # [B, nt] Devex reference weights
    it: torch.Tensor          # [B] total iterations
    stall: torch.Tensor       # [B] consecutive degenerate pivots
    done: torch.Tensor        # [B] bool
    status: torch.Tensor      # [B]


def _nonbasic_values(lo, up, at_upper, in_basis):
    """Value assumed by each nonbasic variable (at a finite bound, else 0)."""
    fin_lo, fin_up = torch.isfinite(lo), torch.isfinite(up)
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    v_lower = torch.where(fin_lo, lo, torch.where(fin_up, up, zero))
    v_upper = torch.where(fin_up, up, torch.where(fin_lo, lo, zero))
    vals = torch.where(at_upper, v_upper, v_lower)
    return torch.where(in_basis, zero, vals)


def lane_group(device) -> int:
    """The lanes of one product call: 16 on the CPU (the shape whose rows
    take MKL's GEMM kernel), 64 on the card (fewer launches at the
    evaluator's 512 lanes)."""
    return 64 if torch.device(device).type == "cuda" else 16


def _grouped(fn, *lanes):
    """``fn`` over groups of ``lane_group`` lanes of the tensors ``lanes``
    (each with the lane axis first, a whole number of groups): every call
    has the same shape, so a lane's bits do not depend on the lane
    count."""
    B = lanes[0].shape[0]
    G = lane_group(lanes[0].device)
    if B == G:
        return fn(*lanes)
    return torch.cat([fn(*(t[g:g + G] for t in lanes))
                      for g in range(0, B, G)])


def _rows_mm(X, M):
    """X [B, k] @ M [k, q] (M shared by the lanes): [B, q]."""
    return _grouped(lambda x: x @ M, X)


def _vec_mat(v, M):
    """Per lane v[b] @ M[b]: v [B, k], M [B, k, q] -> [B, q]."""
    return _grouped(lambda v_, m_: torch.bmm(v_[:, None, :], m_)[:, 0], v, M)


def _mat_vec(M, v):
    """Per lane M[b] @ v[b]: M [B, m, k], v [B, k] -> [B, m]."""
    return _grouped(lambda m_, v_: torch.bmm(m_, v_[:, :, None])[:, :, 0],
                    M, v)


def _lane_dot(a, b):
    """Per lane a[l] . b[l]: [B, k] -> [B] (a reduction whose split may
    follow the number of outputs)."""
    return _grouped(lambda a_, b_: torch.sum(a_ * b_, dim=1), a, b)


def _refactor(A, basis):
    """The basis inverses [B, m, m] (``ops/linalg.refactorize``).  On the
    card in the same groups of lanes, since a batched LU may choose its
    algorithm by the batch; on the CPU LAPACK factors each matrix alone,
    whatever the batch."""
    if basis.device.type != "cuda":
        return refactorize(A, basis)
    return _grouped(lambda bs: refactorize(A, bs), basis)


def _compute_xb(A, b, binv, xn_full):
    rhs_eff = b - _rows_mm(xn_full, A.T)                      # [B, m]
    return _mat_vec(binv, rhs_eff)


def _take(a, idx):
    """Per-lane gather: a [B, k], idx [B] -> [B]."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _put(a, idx, val):
    """Per-lane scatter (out of place): a[b, idx[b]] = val[b]."""
    return a.scatter(1, idx[:, None], val[:, None])


def _certify_optimal(status, dj, in_basis, at_upper, lo, up, c, tol):
    """Demote claimed-OPTIMAL lanes whose clean-refactorization reduced
    costs violate dual feasibility by far more than pivot-tolerance drift
    (the JAX package's defence in depth, kept as it is)."""
    ctol = max(1e-3, 1e3 * tol) * (1.0 + torch.amax(torch.abs(c), dim=1))
    fixed = (up - lo) <= tol
    free_nb = ~in_basis & ~torch.isfinite(lo) & ~torch.isfinite(up)
    at_lo = ~in_basis & ~fixed & (~at_upper | free_nb)
    at_up = ~in_basis & ~fixed & (at_upper | free_nb)
    viol = (at_lo & (dj < -ctol[:, None])) | (at_up & (dj > ctol[:, None]))
    dual_ok = ~torch.any(viol, dim=1)
    return torch.where((status == STATUS_OPTIMAL) & ~dual_ok,
                       torch.full_like(status, STATUS_ITER_LIMIT), status)


def _lanes(a, B, dtype):
    a = a.to(dtype)
    return a.expand(B, -1) if a.dim() == 1 else a


def lane_cap(m: int, n: int, device) -> int:
    """The most lanes one pass of ``solve_lp`` holds for an LP of m rows and
    n structural columns.  A lane keeps about eight [m, m] f64 arrays live
    at once (the inverse, its product-form update, the refactorization's
    gathered basis, factors and residual) and some forty rows of m + n; the
    lanes may take half of the device's memory (40 GB of an 80 GB H100;
    8 GiB on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory // 2
    else:
        budget = 8 << 30
    per_lane = 8 * (8 * m * m + 40 * (m + n))
    # Whole product groups, so that a pass boundary moves no lane.
    G = lane_group(device)
    return max(G, budget // per_lane // G * G)


def _lane_slice(a, lanes: int, sl: slice):
    """Lanes ``sl`` of an argument that may or may not carry the lane axis."""
    if a is None or a.dim() < 2 or a.shape[0] != lanes:
        return a
    return a[sl]


def _pad_lanes(a, lanes: int, to: int):
    """An argument with the lane axis padded from ``lanes`` to ``to`` lanes
    with copies of its lane 0 (one without the lane axis as it is)."""
    if a is None or a.dim() < 2 or a.shape[0] != lanes:
        return a
    return torch.cat([a, a[:1].expand((to - lanes,) + tuple(a.shape[1:]))])


def solve_lp(D, sense, d, l, u, b, *, max_iter: int = 0, tol: float = 1e-9,
             refac_every: int | None = None, stall_limit: int = 24,
             pivot_dtype=None, lite: bool = False,
             partial_pricing: bool = False, pp_window: int = 16,
             pp_cands: int = 256,
             init_basis=None, init_at_upper=None) -> LPResult:
    """Solve  min d'y  s.t.  D y {sense} b,  l <= y <= u  for every lane.

    D: [m, n] and sense: [m] are shared; d: [B, n] and b: [B, m] carry the
    lane axis; l, u: [n] or [B, n].  ``init_basis`` [B, m] and
    ``init_at_upper`` [B, n + m] warm-start the lanes.  ``max_iter=0``
    derives a cap of 4*(m+n)+64; ``refac_every=None`` the refactorization
    cadence max(64, min(512, m // 4)).  More lanes than ``lane_cap`` are
    solved in passes of that many, a guard against running out of memory
    under a user-set EVAL_BATCH (no default configuration reaches it); a
    lane's pivots do not depend on the others or on their count (the module
    docstring), and on the CPU neither does any bit of its result.

    ``lite`` skips the final clean refactorization and reports the
    objective, primal and duals from the loop's last (chunk-end
    refactorized) state, with only the non-finite guard on the status —
    for the out-of-sample evaluator, which reads (obj, status).
    ``pivot_dtype`` (the JAX solver's f32 pivot loop, a TPU economy) is
    accepted and ignored: the port pivots in the input dtype.

    ``partial_pricing`` (the JAX package's candidate-list Devex, an option
    no run path sets): full pricing every ``pp_window`` pivots picks the
    ``pp_cands`` best columns, and the pivots in between price on those
    alone; optimality and infeasibility are decided only at a full
    pricing.  The same pivots as the JAX package's on the same LP.
    """
    Bn = b.shape[0]
    cap = lane_cap(D.shape[0], D.shape[1], D.device)
    if Bn > cap:
        parts = []
        for lo_ in range(0, Bn, cap):
            sl = slice(lo_, min(lo_ + cap, Bn))
            parts.append(solve_lp(
                D, sense, _lane_slice(d, Bn, sl), _lane_slice(l, Bn, sl),
                _lane_slice(u, Bn, sl), b[sl], max_iter=max_iter, tol=tol,
                refac_every=refac_every, stall_limit=stall_limit, lite=lite,
                partial_pricing=partial_pricing, pp_window=pp_window,
                pp_cands=pp_cands, init_basis=_lane_slice(init_basis, Bn, sl),
                init_at_upper=_lane_slice(init_at_upper, Bn, sl)))
        return LPResult(*(torch.cat(f) for f in zip(*parts)))
    # Whole product groups: padded lanes (copies of lane 0) start done, so
    # they neither pivot nor hold the loop, and are dropped at the end.
    live = Bn
    G = lane_group(D.device)
    Bn = -(-live // G) * G
    if Bn != live:
        d, l, u, b, init_basis, init_at_upper = (
            _pad_lanes(a, live, Bn)
            for a in (d, l, u, b, init_basis, init_at_upper))
    dtype = D.dtype
    dev = D.device
    m, n = D.shape
    nt = n + m
    if max_iter == 0:
        max_iter = 4 * (m + n) + 64
    if refac_every is None:
        refac_every = max(64, min(512, m // 4))

    d = _lanes(d, Bn, dtype)
    b = b.to(dtype)
    A = torch.cat([D, torch.eye(m, dtype=dtype, device=dev)], dim=1)
    inf = torch.full((m,), _INF, dtype=dtype, device=dev)
    zm = torch.zeros(m, dtype=dtype, device=dev)
    slack_lo = torch.where(sense > 0, -inf, zm)
    slack_up = torch.where(sense < 0, inf, zm)
    lo = torch.cat([_lanes(l, Bn, dtype), slack_lo.expand(Bn, -1)], dim=1)
    up = torch.cat([_lanes(u, Bn, dtype), slack_up.expand(Bn, -1)], dim=1)
    c = torch.cat([d, zm.expand(Bn, -1)], dim=1)
    fin_lo, fin_up = torch.isfinite(lo), torch.isfinite(up)
    col_ids = torch.arange(nt, device=dev)
    lane_ids = torch.arange(Bn, device=dev)
    eye_m = torch.eye(m, dtype=dtype, device=dev)

    # ---- initial basis: warm start or all-slack ---------------------------
    basis_c = torch.arange(n, n + m, device=dev).expand(Bn, -1)
    in_basis_c = torch.cat([torch.zeros(n, dtype=torch.bool, device=dev),
                            torch.ones(m, dtype=torch.bool, device=dev)]
                           ).expand(Bn, -1)
    at_upper_c = ~fin_lo & fin_up
    if init_basis is None:
        basis0, in_basis0, at_upper0 = basis_c, in_basis_c, at_upper_c
        binv0 = eye_m.expand(Bn, -1, -1)
    else:
        basis_w = init_basis.to(torch.int64)
        in_basis_w = torch.zeros((Bn, nt), dtype=torch.bool, device=dev
                                 ).scatter(1, basis_w, True)
        at_upper_w = (init_at_upper.to(torch.bool) & ~in_basis_w
                      if init_at_upper is not None
                      else at_upper_c & ~in_basis_w)
        binv_w = _refactor(A, basis_w)
        # Singularity guard: a warm basis whose inverse is not finite
        # falls back to the cold all-slack start, lane by lane.
        warm_ok = torch.all(torch.isfinite(binv_w).reshape(Bn, -1), dim=1)
        wk = warm_ok[:, None]
        basis0 = torch.where(wk, basis_w, basis_c)
        in_basis0 = torch.where(wk, in_basis_w, in_basis_c)
        at_upper0 = torch.where(wk, at_upper_w, at_upper_c)
        binv0 = torch.where(wk[:, :, None], binv_w, eye_m)
    basis0 = basis0.contiguous()
    xn0 = _nonbasic_values(lo, up, at_upper0, in_basis0)
    xb0 = _compute_xb(A, b, binv0, xn0)

    i64 = torch.int64
    st = _State(
        basis=basis0, in_basis=in_basis0.contiguous(),
        at_upper=at_upper0.contiguous(), binv=binv0.contiguous(), xb=xb0,
        gamma=torch.ones((Bn, nt), dtype=dtype, device=dev),
        it=torch.zeros(Bn, dtype=i64, device=dev),
        stall=torch.zeros(Bn, dtype=i64, device=dev),
        done=torch.arange(Bn, device=dev) >= live,
        status=torch.full((Bn,), STATUS_OPTIMAL, dtype=i64, device=dev),
    )

    big_ratio = torch.finfo(dtype).max / 8
    feas_tol = max(tol, 1e-9)
    one = torch.ones((), dtype=dtype, device=dev)
    big = torch.full((), big_ratio, dtype=dtype, device=dev)
    not_fixed = (up - lo) > tol
    free_all = ~fin_lo & ~fin_up

    def price(st: _State):
        """Phase and simplex multipliers of every lane: (lo_b, up_b,
        viol_lo, viol_hi, in_phase1, piv)."""
        lo_b = torch.gather(lo, 1, st.basis)
        up_b = torch.gather(up, 1, st.basis)
        viol_lo = st.xb < lo_b - tol
        viol_hi = st.xb > up_b + tol
        in_phase1 = torch.any(viol_lo | viol_hi, dim=1)            # [B]
        # Pricing vector: phase-1 infeasibility gradient or real costs.
        cb1 = torch.where(viol_lo, -one, torch.where(viol_hi, one, 0 * one))
        cb = torch.where(in_phase1[:, None], cb1,
                         torch.gather(c, 1, st.basis))
        piv = _vec_mat(cb, st.binv)                               # [B, m]
        return lo_b, up_b, viol_lo, viol_hi, in_phase1, piv

    def eligible(red, in_basis, at_upper, free_nb, nf):
        """(increase, decrease): nonbasic columns whose reduced costs
        ``red`` improve the objective."""
        elig_inc = ~in_basis & nf & (~at_upper | free_nb) & (red < -tol)
        elig_dec = ~in_basis & nf & (at_upper | free_nb) & (red > tol)
        return elig_inc, elig_dec

    def pivot(st: _State, ph, j, dir_, w):
        """The Harris two-pass ratio test for entering column ``j`` with
        direction ``dir_`` and column ``w`` = B^-1 A_j, and the pivoted (or
        flipped) state of every lane before its Devex update: (basis2,
        in_basis2, at_upper2, binv2, xb2, do_flip, t_star, unbounded,
        stuck, r_leave, leave_var, safe_wr)."""
        basis, in_basis, at_upper, binv, xb = (
            st.basis, st.in_basis, st.at_upper, st.binv, st.xb)
        lo_b, up_b, viol_lo, viol_hi, in_phase1, _ = ph
        delta = -dir_[:, None] * w
        moving_up = delta > tol
        moving_dn = delta < -tol
        upper_target = torch.where(viol_lo, lo_b,
                                   torch.where(viol_hi, _INF * one, up_b))
        lower_target = torch.where(viol_hi, up_b,
                                   torch.where(viol_lo, -_INF * one, lo_b))
        fin_ut, fin_lt = torch.isfinite(upper_target), \
            torch.isfinite(lower_target)
        den_up = torch.where(moving_up, delta, one)
        den_dn = torch.where(moving_dn, delta, one)
        r_up = torch.where(moving_up & fin_ut,
                           (upper_target - xb) / den_up, big)
        r_dn = torch.where(moving_dn & fin_lt,
                           (lower_target - xb) / den_dn, big)
        ratios = torch.clamp(torch.minimum(r_up, r_dn), min=0.0)

        r_up_rel = torch.where(moving_up & fin_ut,
                               (upper_target - xb + feas_tol) / den_up, big)
        r_dn_rel = torch.where(moving_dn & fin_lt,
                               (lower_target - xb - feas_tol) / den_dn, big)
        theta_rel = torch.clamp(torch.amin(
            torch.minimum(r_up_rel, r_dn_rel), dim=1), min=0.0)   # [B]

        span_j = _take(up, j) - _take(lo, j)
        flip_ratio = torch.where(torch.isfinite(span_j), span_j, big)

        # Pass 2: stable leaving row among the relaxed candidates.
        cand = ratios <= theta_rel[:, None]
        leave_score = torch.where(cand, torch.abs(w), -one)
        r_leave = torch.argmax(leave_score, dim=1)                # [B]
        min_basic_ratio = torch.where(torch.any(cand, dim=1),
                                      _take(ratios, r_leave), big)

        t_star = torch.minimum(min_basic_ratio, flip_ratio)
        unbounded = (t_star >= big_ratio) & ~in_phase1
        stuck = (t_star >= big_ratio) & in_phase1
        do_flip = flip_ratio < min_basic_ratio - tol

        # --- apply the step --------------------------------------------
        xb_new = xb + t_star[:, None] * delta
        at_upper_flip = _put(at_upper, j, ~_take(at_upper, j))

        leave_var = _take(basis, r_leave)
        leave_delta = _take(delta, r_leave)
        blocked_at = torch.where(leave_delta > 0,
                                 _take(upper_target, r_leave),
                                 _take(lower_target, r_leave))
        leave_is_upper = torch.abs(blocked_at - _take(up, leave_var)) <= \
            torch.abs(blocked_at - _take(lo, leave_var))

        yes = torch.ones_like(in_phase1)
        basis_new = _put(basis, r_leave, j)
        in_basis_new = _put(_put(in_basis, j, yes), leave_var, ~yes)
        at_upper_new = _put(_put(at_upper, leave_var, leave_is_upper), j,
                            ~yes)

        # Product-form update of the inverse: E = I - (w - e_r)/w_r * e_r'.
        w_r = _take(w, r_leave)
        safe_wr = torch.where(torch.abs(w_r) < 1e-12, one, w_r)
        binv_row_r = binv[lane_ids, r_leave]                      # [B, m]
        eta = _put(-w / safe_wr[:, None], r_leave, 1.0 / safe_wr)
        e_r = eye_m[r_leave]                                      # [B, m]
        binv_new = binv + (eta - e_r)[:, :, None] * binv_row_r[:, None, :]
        x_j_old = _take(_nonbasic_values(lo, up, at_upper, in_basis), j)
        xb_pivot = _put(xb_new, r_leave, x_j_old + dir_ * t_star)

        # Flip: the entering variable stays nonbasic at its other bound.
        fl = do_flip[:, None]
        return (torch.where(fl, basis, basis_new),
                torch.where(fl, in_basis, in_basis_new),
                torch.where(fl, at_upper_flip, at_upper_new),
                torch.where(fl[:, :, None], binv, binv_new),
                torch.where(fl, xb_new, xb_pivot),
                do_flip, t_star, unbounded, stuck, r_leave, leave_var,
                safe_wr, binv_row_r)

    def devex(gamma, gamma_at, j, leave_var, safe_wr, alpha):
        """Devex weights after a pivot (Forrest-Goldfarb reference
        framework): the weights ``gamma_at`` of the columns ``alpha`` (the
        pivot row over them) is taken from, raised to their candidates."""
        g_q = _take(gamma, j)
        cand_g = torch.square(alpha / safe_wr[:, None]) * g_q[:, None]
        gamma_piv = gamma_at(cand_g)
        gamma_piv = _put(gamma_piv, leave_var, torch.clamp(
            g_q / torch.square(safe_wr), min=1.0))
        reset = torch.amax(gamma_piv, dim=1) > 1e8
        return torch.where(reset[:, None], one, gamma_piv)

    def body(st: _State, frozen) -> _State:
        """One pivot of every lane under full pricing."""
        ph = price(st)
        in_phase1, piv = ph[4], ph[5]
        p1 = in_phase1[:, None]
        red = torch.where(p1, 0 * one, c) - _rows_mm(piv, A)      # [B, nt]

        free_nb = ~st.in_basis & free_all
        elig_inc, elig_dec = eligible(red, st.in_basis, st.at_upper,
                                      free_nb, not_fixed)
        elig = elig_inc | elig_dec
        score = torch.where(elig, red * red / st.gamma, -one)

        use_bland = st.stall >= stall_limit
        bland_key = torch.where(elig, -col_ids, -(nt + 1))
        j = torch.where(use_bland, torch.argmax(bland_key, dim=1),
                        torch.argmax(score, dim=1))                # [B]
        any_elig = torch.any(elig, dim=1)

        term_status = torch.where(in_phase1, STATUS_INFEASIBLE,
                                  STATUS_OPTIMAL)
        dir_ = torch.where(_take(elig_inc, j), one, -one)          # [B]

        w = _mat_vec(st.binv, A[:, j].T)                          # [B, m]
        (basis2, in_basis2, at_upper2, binv2, xb2, do_flip, t_star,
         unbounded, stuck, _, leave_var, safe_wr, binv_row_r) = \
            pivot(st, ph, j, dir_, w)
        alpha_row = _rows_mm(binv_row_r, A)                       # [B, nt]
        gamma_piv = devex(st.gamma,
                          lambda g: torch.maximum(st.gamma, g), j,
                          leave_var, safe_wr, alpha_row)
        gamma2 = torch.where(do_flip[:, None], st.gamma, gamma_piv)

        degen = t_star <= tol
        stall_new = torch.where(degen, st.stall + 1, 0)

        finished = ~any_elig | unbounded | stuck
        status_new = torch.where(
            ~any_elig, term_status,
            torch.where(unbounded, STATUS_UNBOUNDED,
                        torch.where(stuck, STATUS_INFEASIBLE, st.status)))

        # Keep the pre-step state when this step finished the lane or when
        # the lane was already done (or frozen at its cap).
        skip = st.done | frozen
        keep = (finished | skip)[:, None]
        return _State(
            basis=torch.where(keep, st.basis, basis2),
            in_basis=torch.where(keep, st.in_basis, in_basis2),
            at_upper=torch.where(keep, st.at_upper, at_upper2),
            binv=torch.where(keep[:, :, None], st.binv, binv2),
            xb=torch.where(keep, st.xb, xb2),
            gamma=torch.where(keep, st.gamma, gamma2),
            it=torch.where(skip, st.it, st.it + 1),
            stall=torch.where(skip, st.stall, stall_new),
            done=st.done | (finished & ~frozen),
            status=torch.where(skip, st.status, status_new),
        )

    # ---- partial pricing (opt-in): candidate-list Devex -----------------
    # Full pricing every ``win`` pivots decides termination (no eligible
    # column: OPTIMAL, or INFEASIBLE in phase 1) and picks the top NC
    # columns by Devex score (Bland's order once stalled), ties to the
    # lower index; the pivots in between price and update Devex weights on
    # the gathered [m, NC] block alone.  A lane with no eligible candidate
    # idles to the next full pricing; unboundedness or phase-1 stuckness
    # found on a candidate column is global and ends the lane at once.
    NC = min(pp_cands, nt)
    neg_big = torch.full((), -big_ratio, dtype=dtype, device=dev)

    def refresh(st: _State, frozen):
        """Full pricing: the lanes with no eligible column end, and every
        lane's NC candidates (indices [B, NC], columns [B, m, NC])."""
        ph = price(st)
        in_phase1, piv = ph[4], ph[5]
        red = torch.where(in_phase1[:, None], 0 * one, c) - \
            _rows_mm(piv, A)
        free_nb = ~st.in_basis & free_all
        elig_inc, elig_dec = eligible(red, st.in_basis, st.at_upper,
                                      free_nb, not_fixed)
        elig = elig_inc | elig_dec
        ends = ~torch.any(elig, dim=1) & ~st.done & ~frozen
        term_status = torch.where(in_phase1, STATUS_INFEASIBLE,
                                  STATUS_OPTIMAL)
        use_bland = (st.stall >= stall_limit)[:, None]
        score = torch.where(elig, red * red / st.gamma, neg_big)
        bland = torch.where(elig, -col_ids.to(dtype), neg_big)
        sel = torch.where(use_bland, bland, score)
        cand_idx = torch.sort(sel, dim=1, descending=True,
                              stable=True).indices[:, :NC]        # [B, NC]
        A_C = A[:, cand_idx].permute(1, 0, 2)                     # [B, m, NC]
        st = st._replace(done=st.done | ends,
                         status=torch.where(ends, term_status, st.status))
        return st, cand_idx, A_C

    def body_candidates(st: _State, frozen, cand_idx, A_C) -> _State:
        """One pivot of every lane priced on its candidates alone."""
        ph = price(st)
        in_phase1, piv = ph[4], ph[5]
        c_C = torch.gather(c, 1, cand_idx)
        red_C = torch.where(in_phase1[:, None], 0 * one, c_C) - \
            _vec_mat(piv, A_C)                                    # [B, NC]
        lo_C = torch.gather(lo, 1, cand_idx)
        up_C = torch.gather(up, 1, cand_idx)
        inb_C = torch.gather(st.in_basis, 1, cand_idx)
        atu_C = torch.gather(st.at_upper, 1, cand_idx)
        free_C = ~inb_C & ~torch.isfinite(lo_C) & ~torch.isfinite(up_C)
        elig_inc_C, elig_dec_C = eligible(red_C, inb_C, atu_C, free_C,
                                          (up_C - lo_C) > tol)
        elig_C = elig_inc_C | elig_dec_C
        any_elig_C = torch.any(elig_C, dim=1)

        gamma_C = torch.gather(st.gamma, 1, cand_idx)
        score_C = torch.where(elig_C, red_C * red_C / gamma_C, -one)
        bland_C = torch.where(elig_C, -cand_idx, -(nt + 1))
        use_bland = st.stall >= stall_limit
        jc = torch.where(use_bland, torch.argmax(bland_C, dim=1),
                         torch.argmax(score_C, dim=1))            # [B]
        j = _take(cand_idx, jc)
        dir_ = torch.where(_take(elig_inc_C, jc), one, -one)

        w = _mat_vec(st.binv, A_C[lane_ids, :, jc])               # [B, m]
        (basis2, in_basis2, at_upper2, binv2, xb2, do_flip, t_star,
         unbounded, stuck, _, leave_var, safe_wr, binv_row_r) = \
            pivot(st, ph, j, dir_, w)
        # An idle lane (no eligible candidate) has no real entering column:
        # its ratio test certifies nothing.
        unbounded = unbounded & any_elig_C
        stuck = stuck & any_elig_C
        alpha_C = _vec_mat(binv_row_r, A_C)                       # [B, NC]
        gamma_piv = devex(st.gamma,
                          lambda g: st.gamma.scatter_reduce(
                              1, cand_idx, g, "amax"),
                          j, leave_var, safe_wr, alpha_C)
        gamma2 = torch.where(do_flip[:, None], st.gamma, gamma_piv)

        degen = t_star <= tol
        skip = st.done | frozen
        keep = ~any_elig_C | unbounded | stuck | skip
        did = ~keep
        k2 = keep[:, None]
        status_new = torch.where(
            unbounded, STATUS_UNBOUNDED,
            torch.where(stuck, STATUS_INFEASIBLE, st.status))
        return _State(
            basis=torch.where(k2, st.basis, basis2),
            in_basis=torch.where(k2, st.in_basis, in_basis2),
            at_upper=torch.where(k2, st.at_upper, at_upper2),
            binv=torch.where(k2[:, :, None], st.binv, binv2),
            xb=torch.where(k2, st.xb, xb2),
            gamma=torch.where(k2, st.gamma, gamma2),
            it=torch.where(did, st.it + 1, st.it),
            stall=torch.where(did, torch.where(degen, st.stall + 1, 0),
                              st.stall),
            done=st.done | ((unbounded | stuck) & ~skip),
            status=torch.where(skip, st.status, status_new),
        )

    # One refactorization per ``chunk`` pivots (the JAX loop's cadence);
    # with partial pricing, chunk // win windows of win pivots, each after
    # a full pricing.
    chunk = max(8, min(refac_every, m))
    win = max(1, min(pp_window, chunk))
    while True:
        active = ~st.done & (st.it < max_iter)
        if not bool(torch.any(active)):
            break
        frozen = ~active
        if partial_pricing:
            for _ in range(max(1, chunk // win)):
                st, cand_idx, A_C = refresh(st, frozen)
                for _ in range(win):
                    st = body_candidates(st, frozen, cand_idx, A_C)
                if bool(torch.all(st.done | frozen)):
                    break
        else:
            for _ in range(chunk):
                st = body(st, frozen)
                if bool(torch.all(st.done | frozen)):
                    break
        binv_ = _refactor(A, st.basis)
        xn_full = _nonbasic_values(lo, up, st.at_upper, st.in_basis)
        xb_ = _compute_xb(A, b, binv_, xn_full)
        a3 = active[:, None]
        st = st._replace(binv=torch.where(a3[:, :, None], binv_, st.binv),
                         xb=torch.where(a3, xb_, st.xb))

    final = st
    status = torch.where(final.done, final.status,
                         torch.full_like(final.status, STATUS_ITER_LIMIT))
    cstat_full = torch.where(
        final.in_basis, BASIC,
        torch.where(free_all, FREE_NB,
                    torch.where(final.at_upper, AT_UPPER, AT_LOWER)))

    if lite:
        xn_full = _nonbasic_values(lo, up, final.at_upper, final.in_basis)
        x_full = xn_full.scatter(1, final.basis, final.xb)
        cb = torch.gather(c, 1, final.basis)
        pi = _vec_mat(cb, final.binv)
        dj_full = c - _rows_mm(pi, A)
        obj = _lane_dot(c, x_full)
        # Non-finite guard: a NaN/inf objective is never OPTIMAL (the
        # evaluator counts optimal lanes into its estimate).
        status = torch.where(torch.isfinite(obj), status,
                             torch.full_like(status, STATUS_ITER_LIMIT))
        return _live_lanes(LPResult(
            status=status, obj=obj, y=x_full[:, :n], pi=pi,
            dj=dj_full[:, :n], cstat=cstat_full[:, :n],
            rstat=cstat_full[:, n:], basis=final.basis, binv=final.binv,
            iters=final.it, farkas=torch.zeros_like(pi)), live)

    # ---- clean final quantities from a refactorization of the basis -----
    binv = _refactor(A, final.basis)
    xn_full = _nonbasic_values(lo, up, final.at_upper, final.in_basis)
    xb = _compute_xb(A, b, binv, xn_full)
    x_full = xn_full.scatter(1, final.basis, xb)

    cb = torch.gather(c, 1, final.basis)
    pi = _vec_mat(cb, binv)                                       # [B, m]
    dj_full = c - _rows_mm(pi, A)
    obj = _lane_dot(c, x_full)

    # Farkas ray for infeasible LPs: the phase-1 multipliers.
    lo_b = torch.gather(lo, 1, final.basis)
    up_b = torch.gather(up, 1, final.basis)
    cb1 = torch.where(xb < lo_b - 1e-7, -one,
                      torch.where(xb > up_b + 1e-7, one, 0 * one))
    farkas = _vec_mat(cb1, binv)
    farkas = torch.where((status == STATUS_INFEASIBLE)[:, None], farkas,
                         0 * one)

    # Non-finite guard, then the independent dual certification.
    ok_num = torch.isfinite(obj) & torch.all(torch.isfinite(pi), dim=1)
    status = torch.where(ok_num, status,
                         torch.full_like(status, STATUS_ITER_LIMIT))
    status = _certify_optimal(status, dj_full, final.in_basis,
                              final.at_upper, lo, up, c, tol)

    return _live_lanes(LPResult(
        status=status, obj=obj, y=x_full[:, :n], pi=pi, dj=dj_full[:, :n],
        cstat=cstat_full[:, :n], rstat=cstat_full[:, n:],
        basis=final.basis, binv=binv, iters=final.it, farkas=farkas,
    ), live)


def _live_lanes(res: LPResult, live: int) -> LPResult:
    """The first ``live`` lanes of ``res`` (the others were padding)."""
    if res.status.shape[0] == live:
        return res
    return LPResult(*(f[:live] for f in res))
