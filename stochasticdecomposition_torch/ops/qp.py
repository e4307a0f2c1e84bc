"""Dense primal-dual interior-point solver for the regularized master QP.

The port of the JAX package's ``ops/qp.py``: one Mehrotra predictor-corrector
with dense KKT solves (the replacement for the CPLEX QP solves of the
reference master, master.c:41 with the separable proximal Q of
master.c:191-211), row equilibration, a soft acceptance test and the
active-set polish.  The KKT systems are solved with ``torch.linalg`` in f64
(LU with partial pivoting) plus one refinement pass, where the JAX package
used its Gauss-Jordan routine.

Problem form:   min 0.5 v'Qv + c'v   s.t.  A v = b,   G v <= h.

Duals follow the CPLEX minimization convention used by the reference
bootstrap lower bound (optimal.c:240-338): multipliers ``z`` of the G rows
are nonnegative; callers flip signs when mapping back to >=/<= rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPResult(NamedTuple):
    converged: bool
    v: torch.Tensor           # [n] primal solution
    obj: torch.Tensor         # 0.5 v'Qv + c'v
    y: torch.Tensor           # [me] equality duals (free sign)
    z: torch.Tensor           # [mi] inequality duals (>= 0)
    s: torch.Tensor           # [mi] slacks of G v <= h
    iters: int
    gap: torch.Tensor         # final complementarity measure


def _solve(K, rhs):
    """K x = rhs with one refinement pass (LU, no error check or sync: a
    singular system yields non-finite values, as the Gauss-Jordan
    routine's did, and the acceptance tests reject them)."""
    x = torch.linalg.solve_ex(K, rhs)[0]
    return x + torch.linalg.solve_ex(K, rhs - K @ x)[0]


def solve_qp(Q, c, A, b, G, h, *, max_iter: int = 200, tol: float = 1e-9,
             ineq_mask=None, eq_mask=None, polish: bool = True,
             consistent_clamp: bool = False) -> QPResult:
    """Solve the convex QP.  Empty A/G allowed (0 rows).

    ``max_iter`` is 200 where the JAX package has 60: storm-scale masters
    (stormlike, 122 variables, ~210 active rows) can need 85 iterations,
    and at 60 both packages stop uncertified far from the optimum.  A solve
    that converges within 60 iterations is unchanged.

    ``ineq_mask``/``eq_mask`` optionally disable padded rows (True = active):
    masked-out inequality rows behave as 0'v <= 1, masked-out equality rows as
    0'v = 0, so callers can preallocate constraint blocks at fixed capacity.

    ``consistent_clamp`` (the compromise QP): the dual step is taken with
    the clamped barrier weights the KKT matrix was built with, so each step
    keeps the linearised dual residual at zero.  Without it (the JAX
    package's solver, kept for the master's parity), rows whose z/s passes
    the clamp get a dual step the KKT matrix did not see: in a degenerate
    end game the dual residual then jumps from 1e-7 to ~1, and the loop
    wanders to its cap (the compromise of two short stormlike replications
    stalls so in both packages; with the flag it certifies in 17-30
    iterations).
    """
    dtype, dev = Q.dtype, Q.device
    n = Q.shape[0]
    me = A.shape[0]
    mi = G.shape[0]
    one = torch.ones((), dtype=dtype, device=dev)

    if ineq_mask is not None:
        G = torch.where(ineq_mask[:, None], G, 0.0)
        h = torch.where(ineq_mask, h, 1.0)
    if eq_mask is not None:
        A = torch.where(eq_mask[:, None], A, 0.0)
        b = torch.where(eq_mask, b, 0.0)

    # --- row equilibration: every constraint row to unit inf-norm ---------
    def _row_scale(Mat):
        if Mat.shape[0] == 0:
            return torch.zeros(0, dtype=dtype, device=dev)
        r = torch.amax(torch.abs(Mat), dim=1)
        return torch.where(r > 0, r, one)

    rG = _row_scale(G)
    if mi:
        G = G / rG[:, None]
        h = h / rG
    rA = _row_scale(A)
    if me:
        A = A / rA[:, None]
        b = b / rA

    # Residuals are tested relative to their own data scale.
    scale_d = 1.0 + torch.amax(torch.abs(c))
    scale_p = (1.0 + torch.amax(torch.abs(b))) if me else one
    scale_g = (1.0 + torch.amax(torch.abs(h))) if mi else one

    v = torch.zeros(n, dtype=dtype, device=dev)
    y = torch.zeros(me, dtype=dtype, device=dev)
    s = torch.clamp(torch.abs(h), min=1.0)
    z = torch.ones(mi, dtype=dtype, device=dev)

    eq_reg = 1e-10   # tiny dual regularization keeps padded eq rows nonsingular
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    if me:
        At = A.T
        K_low = torch.cat(
            [A, -eq_reg * torch.eye(me, dtype=dtype, device=dev)], dim=1)

    def kkt_solve(M, rhs_v, rhs_y):
        """[[M, A'], [A, -eq_reg I]] [dv, dy] = [rhs_v, rhs_y]."""
        if me == 0:
            return _solve(M, rhs_v), rhs_y
        K = torch.cat([torch.cat([M, At], dim=1), K_low], dim=0)
        sol = _solve(K, torch.cat([rhs_v, rhs_y]))
        return sol[:n], sol[n:]

    def max_step(x, dx):
        if not mi:
            return one
        neg = dx < 0
        r = torch.where(neg, -x / torch.where(neg, dx, -one), torch.inf)
        return torch.clamp(torch.amin(r), max=1.0)

    def mean_sz(s_, z_):
        return torch.dot(s_, z_) / max(mi, 1)

    zero_r = torch.zeros((), dtype=dtype, device=dev)
    done = False
    it = 0
    gap = torch.full((), torch.inf, dtype=dtype, device=dev)
    while it < max_iter:
        rd = Q @ v + c
        if me:
            rd = rd + At @ y
            rp = A @ v - b
        else:
            rp = torch.zeros(0, dtype=dtype, device=dev)
        rd = rd + G.T @ z
        rg = G @ v + s - h
        mu = mean_sz(s, z)
        gap = mu
        res_rel = torch.maximum(
            torch.amax(torch.abs(rd)) / scale_d,
            torch.maximum(
                (torch.amax(torch.abs(rg)) / scale_g) if mi else zero_r,
                (torch.amax(torch.abs(rp)) / scale_p) if me else zero_r))
        it += 1
        if bool((res_rel < tol * 10) & (mu < tol * scale_d)):
            done = True
            break

        # Clamp the barrier weights (unbounded z/s ratios make the late KKT
        # systems unsolvable).
        zs = torch.clamp(z / s, 1e-10, 1e12)
        M = Q + (G.T * zs) @ G + 1e-12 * eye_n

        # --- affine (predictor) step ---
        rc_aff = z * s
        rhs_v = -(rd + G.T @ ((-rc_aff + z * rg) / s))
        dv_aff, dy_aff = kkt_solve(M, rhs_v, -rp)
        ds_aff = -rg - G @ dv_aff
        dz_aff = ((-rc_aff + z * rg) / s + zs * (G @ dv_aff)
                  if consistent_clamp else (-rc_aff - z * ds_aff) / s)

        ap_aff = max_step(s, ds_aff)
        ad_aff = max_step(z, dz_aff)
        mu_aff = mean_sz(s + ap_aff * ds_aff, z + ad_aff * dz_aff)
        sigma = (mu_aff / torch.clamp(mu, min=1e-300)) ** 3

        # --- corrector step ---
        rc = z * s + ds_aff * dz_aff - sigma * mu
        rhs_v = -(rd + G.T @ ((-rc + z * rg) / s))
        dv, dy = kkt_solve(M, rhs_v, -rp)
        ds = -rg - G @ dv
        dz = ((-rc + z * rg) / s + zs * (G @ dv)
              if consistent_clamp else (-rc - z * ds) / s)

        frac = 0.995
        ap = frac * max_step(s, ds)
        ad = frac * max_step(z, dz)
        v = v + ap * dv
        s = s + ap * ds
        y = y + ad * dy
        z = z + ad * dz

    # Soft acceptance: a KKT point at 1e-6 accuracy (far tighter than the
    # algorithmic tolerances consuming these solutions).
    soft = 1e-6
    rd_f = Q @ v + c + (At @ y if me else 0.0) + G.T @ z
    parts = [torch.abs(rd_f) / scale_d, torch.zeros(1, dtype=dtype, device=dev)]
    if mi:
        parts.append(torch.abs(G @ v + s - h) / scale_g)
    if me:
        parts.append(torch.abs(A @ v - b) / scale_p)
    res_f = torch.amax(torch.cat(parts))
    mu_f = (torch.dot(s, z) / mi) if mi else zero_r
    done = done or bool((res_f < soft) & (mu_f < soft * scale_d))

    # Undo the row equilibration (z_orig = z_s / r).
    if mi:
        z = z / rG
        s = s * rG
        G = G * rG[:, None]
        h = h * rG
    if me:
        y = y / rA
        A = A * rA[:, None]
        b = b * rA

    # ---- active-set polish ("crossover-lite") ---------------------------
    # Re-solve the KKT equalities on the identified active set and keep the
    # polished point if it satisfies the full KKT system; a polished point
    # that passes is a certified optimum, so it also upgrades ``done``.
    if mi and polish:
        slack = h - G @ v
        act = (z > slack).to(dtype)
        reg = 1e-12
        top = torch.cat([Q, A.T, G.T], dim=1) if me else \
            torch.cat([Q, G.T], dim=1)
        rows = [top]
        if me:
            rows.append(torch.cat(
                [A, -reg * torch.eye(me, dtype=dtype, device=dev),
                 torch.zeros((me, mi), dtype=dtype, device=dev)], dim=1))
        bot = [act[:, None] * G]
        if me:
            bot.append(torch.zeros((mi, me), dtype=dtype, device=dev))
        bot.append(torch.diag(-(1.0 - act) - reg))
        rows.append(torch.cat(bot, dim=1))
        K = torch.cat(rows, dim=0)
        rhs = torch.cat([-c] + ([b] if me else []) + [act * h])
        sol = _solve(K, rhs)
        v_p = sol[:n]
        y_p = sol[n:n + me]
        z_p = sol[n + me:]
        # Acceptance checks relative to the row/dual scale.
        feas = torch.all(G @ v_p - h <= 1e-7 * (1.0 + torch.abs(h)))
        feas = feas & (torch.amin(z_p) >= -1e-7 * scale_d)
        if me:
            feas = feas & torch.all(
                torch.abs(A @ v_p - b) <= 1e-7 * (1.0 + torch.abs(b)))
        rd_p = Q @ v_p + c + (A.T @ y_p if me else 0.0) + \
            G.T @ torch.clamp(z_p, min=0.0)
        stat_ok = torch.amax(torch.abs(rd_p)) <= soft * scale_d
        if bool(feas & stat_ok):
            v = v_p
            y = y_p if me else y
            z = torch.clamp(z_p, min=0.0)
            s = torch.clamp(h - G @ v, min=0.0)
            done = True

    obj = 0.5 * v @ (Q @ v) + c @ v
    return QPResult(converged=done, v=v, obj=obj, y=y, z=z, s=s,
                    iters=it, gap=gap)
