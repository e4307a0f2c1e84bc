"""Out-of-sample evaluation, batched.

Reference: evaluate.c — a sequential loop of CPLEX solves with a Welford
mean/variance update and the 95%-CI stopping rule (evaluate.c:49).  Here
each round draws EVAL_BATCH observations and solves them as the lanes of one
``solve_lp`` call, warm-started from the mean observation's basis; the
port of the JAX package's ``core/evaluate.py``.  The card holds the lanes
whole (``ops/simplex.lane_cap``): there is no chunking or staging.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import ProblemArrays
from stochasticdecomposition_torch.core.update import (
    subproblem_rhs_cost_lanes,
)
from stochasticdecomposition_torch.ops.simplex import (
    AT_UPPER, STATUS_OPTIMAL, solve_lp,
)
from stochasticdecomposition_torch.sampler import SamplerSpec, sample_omega


class EvalResult(NamedTuple):
    mean: float          # total objective estimate: c'x + E[h(x, omega)]
    stdev: float         # stdev of the recourse term estimate
    count: int           # observations used
    ci_low: float
    ci_high: float
    error: float         # 3.29 stdev / mean (reference inout.c:37 convention)
    dropped: int = 0     # infeasible subproblem lanes excluded from the mean


def eval_generator(seed: int, device) -> torch.Generator:
    """The evaluation's own generator, seeded from EVAL_SEED[rep]."""
    g = torch.Generator(device=torch.device(device))
    child = np.random.SeedSequence(int(seed))
    g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
    return g


def make_eval_batch(pa: ProblemArrays, spec: SamplerSpec, batch: int,
                    pivot_dtype=None):
    """``eval_batch(x, gen=None, w_raw=None) -> (mean, M2, n_ok, n)`` over
    one batch of n observations: the mean of the n_ok optimal lanes'
    objectives and the sum of their squared deviations from it (the
    per-batch Welford statistics, evaluate.c:86-93), merged on the host by
    :func:`welford_merge`.

    ``gen`` draws the batch; ``w_raw`` [batch, R] (raw, uncentered) injects
    it.  The mean observation is solved once per x and every lane is
    warm-started from its basis (all lanes share x and differ in rhs and
    cost only).  ``pivot_dtype`` (EVAL_F32_PIVOT) is accepted; the solves
    are f64."""
    del pivot_dtype
    base_for = {}

    def _base(x):
        key = x.cpu().numpy().tobytes()
        if key not in base_for:
            base_for.clear()
            zero = torch.zeros_like(pa.omega_mean)[None]
            rhs0, cost0 = subproblem_rhs_cost_lanes(pa, x, zero)
            base = solve_lp(pa.D, pa.sense2, cost0, pa.l2, pa.u2, rhs0,
                            lite=True)
            eval_batch.base_pivots += int(base.iters[0])
            atup = torch.cat([base.cstat, base.rstat], dim=1) == AT_UPPER
            base_for[key] = (base.basis, atup)
        return base_for[key]

    def solve_lanes(x, w_raw):
        """(objs, ok) [n] of the lanes of raw observations ``w_raw``."""
        dtype = pa.c1.dtype
        x = torch.as_tensor(x, dtype=dtype, device=pa.c1.device)
        w = torch.as_tensor(w_raw, dtype=dtype, device=x.device) - \
            pa.omega_mean[None]
        n = w.shape[0]
        basis, atup = _base(x)
        rhs, cost = subproblem_rhs_cost_lanes(pa, x, w)
        res = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs, lite=True,
                       init_basis=basis.expand(n, -1),
                       init_at_upper=atup.expand(n, -1))
        eval_batch.pivots += int(torch.sum(res.iters))
        return res.obj, res.status == STATUS_OPTIMAL

    def eval_batch(x, gen=None, w_raw=None):
        if w_raw is None:
            w_raw = sample_omega(spec, gen, batch, dtype=pa.c1.dtype)
        objs, ok = solve_lanes(x, w_raw)
        return (*batch_stats(objs, ok), ok.shape[0])

    # Pivots of the lanes, and of the mean-observation solves.
    eval_batch.pivots = 0
    eval_batch.base_pivots = 0
    # The lanes alone, for an evaluation that splits them across ranks
    # (parallel/mesh.make_sharded_eval), and the mean observation's warm
    # basis at x, (basis, at_upper), solved once per x.
    eval_batch.solve_lanes = solve_lanes
    eval_batch.mean_basis = _base
    return eval_batch


def batch_stats(objs, ok):
    """(mean, M2, n_ok) of the optimal lanes' objectives: their mean and
    the sum of their squared deviations from it."""
    objs = torch.where(ok, objs, 0.0)
    n_ok = int(torch.sum(ok))
    mean = torch.sum(objs) / max(n_ok, 1)
    dev = torch.where(ok, objs - mean, 0.0)
    return float(mean), float(torch.sum(dev * dev)), n_ok


def welford_merge(n, mean, M2, nb, mean_b, m2_b):
    """Chan-style parallel merge of two Welford accumulators.

    The batched analog of the reference's scalar update (evaluate.c:86-93):
    combines (count, mean, sum-of-squared-deviations) statistics without the
    catastrophic cancellation of sum/sum-of-squares accumulation."""
    nb = int(nb)
    if nb == 0:
        return n, mean, M2
    mean_b = float(mean_b)
    m2_b = float(m2_b)
    n_new = n + nb
    delta = mean_b - mean
    mean = mean + delta * nb / n_new
    M2 = M2 + m2_b + delta * delta * n * nb / n_new
    return n_new, mean, M2


def evaluate(pa: ProblemArrays, spec: SamplerSpec, cfg: SDConfig, x,
             gen: torch.Generator | None = None, *, max_obs: int = 200_000,
             eval_batch_fn=None, max_dropped_frac: float = 0.01,
             draws=None) -> EvalResult:
    """evaluate (evaluate.c:16-111): estimate c'x + E[h] until
    3.92 stdev <= EVAL_ERROR |mean| with at least EVAL_MIN_ITER
    observations, or ``max_obs``.

    Each round draws EVAL_BATCH observations from ``gen``, or takes the next
    [n, R] array of ``draws`` (injected draws).  A lane that does not solve
    to optimality is left out of the mean and counted (``dropped``) against
    the lanes ``eval_batch_fn`` reports it solved; above
    ``max_dropped_frac`` of the lanes the evaluation
    raises, as an infeasible evaluation subproblem is an error in the
    reference (evaluate.c:70-76)."""
    fn = eval_batch_fn or make_eval_batch(pa, spec, cfg.EVAL_BATCH)
    x = torch.as_tensor(np.asarray(x), dtype=pa.c1.dtype, device=pa.c1.device)
    draws = None if draws is None else iter(draws)

    n = 0
    n_drawn = 0
    mean = 0.0
    M2 = 0.0
    stdev = float("inf")
    while n < max_obs:
        if draws is None:
            mb, m2b, ok, lanes = fn(x, gen)
        else:
            mb, m2b, ok, lanes = fn(x, w_raw=next(draws))
        n, mean, M2 = welford_merge(n, mean, M2, ok, mb, m2b)
        n_drawn += lanes
        if n > 1:
            var = max(M2 / (n - 1), 0.0)
            stdev = math.sqrt(var / n)
        if n >= cfg.EVAL_MIN_ITER and \
                3.92 * stdev <= cfg.EVAL_ERROR * abs(mean):
            break

    dropped = n_drawn - n
    if dropped:
        frac = dropped / max(n_drawn, 1)
        if frac > max_dropped_frac:
            raise RuntimeError(
                f"evaluation dropped {dropped}/{n_drawn} infeasible "
                f"subproblem lanes ({100 * frac:.2f}% > "
                f"{100 * max_dropped_frac:.2f}%); the UB estimate would be "
                "biased (evaluate.c:70-76 treats this as an error)")
        warnings.warn(
            f"evaluation dropped {dropped}/{n_drawn} infeasible subproblem "
            "lanes; UB estimate excludes them", RuntimeWarning)

    total = mean + float(pa.c1 @ x)
    return EvalResult(
        mean=total, stdev=stdev, count=n,
        ci_low=total - 1.645 * stdev, ci_high=total + 1.645 * stdev,
        error=3.29 * stdev / total if total else float("inf"),
        dropped=dropped,
    )
