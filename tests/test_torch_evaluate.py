"""Out-of-sample evaluation and result files: the port against the JAX
package.

- ``welford_merge`` on tests/test_welford.py's cases: the port's merge gives
  the JAX package's numbers exactly and keeps their precision.
- One evaluation batch (mean, M2, n_ok) against the JAX package's
  ``make_eval_batch`` on the JAX package's draws, injected: 1e-9 relative,
  n_ok exact; and a whole ``evaluate`` loop (stopping rule, count, CI) on
  the draws of JAX's key splits, to 1e-9.
- ``solve_lp(lite=True)``: the full solve's status and objective (1e-9),
  and the JAX package's lite solve's.
- The result files of one run: the JAX package's writers and the port's
  give the same detailedResults.csv, incumb.dat and results.jsonl, and the
  same summary.dat apart from the line that names the implementation.
- Dropped lanes are counted, and above 1 % of the lanes drawn the
  evaluation raises.
- ``SDSolver.run`` with EVAL_FLAG on the CPU: the upper-bound estimate of
  the certified lands incumbent within 1 % of its exact objective.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.evaluate import (
    EvalResult, evaluate, make_eval_batch, welford_merge,
)
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.update import (
    subproblem_rhs_cost_lanes,
)
from stochasticdecomposition_torch.models.extensive import (
    enumerate_scenarios, exact_objective_fn,
)
from stochasticdecomposition_torch.ops.simplex import solve_lp
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from stochasticdecomposition_tpu.core import evaluate as jeval
from stochasticdecomposition_tpu.ops.simplex import solve_lp as jax_solve_lp
from stochasticdecomposition_tpu.sampler import sample_omega as jax_sample
from torch_common import CPU, jax_solver, port_problem

EVAL_NAMES = ["lands", "pgp2like", "randc_s2"]


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _merge_stream(merge, batches):
    n, mean, M2 = 0, 0.0, 0.0
    for b in batches:
        nb = len(b)
        mb = float(np.mean(b)) if nb else 0.0
        m2b = float(np.sum((b - mb) ** 2)) if nb else 0.0
        n, mean, M2 = merge(n, mean, M2, nb, mb, m2b)
    return n, mean, M2


@pytest.mark.parametrize("case", ["storm_magnitude", "uneven_batches"])
def test_welford_merge_matches_jax(case):
    if case == "storm_magnitude":
        rng = np.random.default_rng(0)
        data = 1.5e7 + 1e-2 * rng.standard_normal(100_000)
        batches = np.split(data, 200)
    else:
        rng = np.random.default_rng(1)
        data = rng.standard_normal(1000) * 3.0 + 7.0
        batches = np.split(data, np.cumsum([0, 1, 17, 250, 2, 0, 500]))
    got = _merge_stream(welford_merge, batches)
    assert got == _merge_stream(jeval.welford_merge, batches)
    n, mean, M2 = got
    assert n == len(data)
    assert abs(mean - np.mean(data)) <= 1e-9 * abs(np.mean(data))
    ref_var = np.var(data, ddof=1)
    assert abs(M2 / (n - 1) - ref_var) <= 1e-6 * ref_var


def _port_solver(name, **cfg):
    return SDSolver(port_problem(name),
                    SDConfig(EVAL_FLAG=False, MAX_ITER=64, **cfg),
                    device="cpu")


@pytest.mark.parametrize("name", EVAL_NAMES)
def test_eval_batch_matches_jax(name):
    batch = 96
    js = jax_solver(name, MAX_ITER=64)
    ps = _port_solver(name)
    x = np.array(js.mean_sol)
    key = jax.random.PRNGKey(17)
    want = jeval.make_eval_batch(js.pa, js.spec, batch)(jnp.asarray(x), key)
    draws = np.array(jax_sample(js.spec, key, batch, dtype=jnp.float64))
    got = make_eval_batch(ps.pa, ps.spec, batch)(
        torch.as_tensor(x), w_raw=torch.as_tensor(draws))
    assert got[2] == int(want[2]) == got[3] == batch
    assert _rel(got[0], want[0]) <= 1e-9
    assert _rel(got[1], want[1]) <= 1e-9 * max(1.0, abs(float(want[0])))


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
def test_evaluate_loop_matches_jax(name):
    kw = dict(EVAL_BATCH=64, EVAL_MIN_ITER=100, EVAL_ERROR=0.002)
    js = jax_solver(name, MAX_ITER=64, **kw)
    ps = _port_solver(name, **kw)
    x = np.array(js.mean_sol)
    key = jax.random.PRNGKey(5)
    want = jeval.evaluate(js.pa, js.spec, JaxConfig(MAX_ITER=64, **kw), x,
                          key, max_obs=64 * 12)
    # The draws of evaluate's key splits, round by round.
    draws, k = [], key
    for _ in range(12):
        k, sub = jax.random.split(k)
        draws.append(np.array(jax_sample(js.spec, sub, 64,
                                         dtype=jnp.float64)))
    got = evaluate(ps.pa, ps.spec, ps.cfg, x, max_obs=64 * 12, draws=draws)
    assert got.count == want.count and got.dropped == want.dropped == 0
    assert got.count > kw["EVAL_MIN_ITER"]
    for f in ("mean", "stdev", "ci_low", "ci_high", "error"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-9, f


@pytest.mark.parametrize("name", ["lands", "pgp2like", "randc_s2"])
def test_lite_solve_matches_full_and_jax(name):
    js = jax_solver(name, MAX_ITER=64)
    pa = stage_problem(port_problem(name), CPU)
    rng = np.random.default_rng(8)
    R = pa.omega_mean.shape[0]
    W = torch.as_tensor(rng.normal(0.0, 0.5, (7, R)) *
                        np.maximum(np.abs(np.array(js.pa.omega_mean)), 1.0))
    x = torch.as_tensor(np.array(js.mean_sol))
    rhs, cost = subproblem_rhs_cost_lanes(pa, x, W)
    full = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs)
    lite = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs, lite=True)
    assert torch.equal(lite.status, full.status)
    assert torch.equal(lite.iters, full.iters)
    assert _rel(lite.obj, full.obj) <= 1e-9
    jl = jax.vmap(lambda c, b: jax_solve_lp(
        js.pa.D, js.pa.sense2, c, js.pa.l2, js.pa.u2, b, lite=True))(
            jnp.asarray(cost.numpy()), jnp.asarray(rhs.numpy()))
    np.testing.assert_array_equal(lite.status.numpy(), np.asarray(jl.status))
    assert _rel(lite.obj, jl.obj) <= 1e-9


def _results(pkg_runner, pkg_eval, x, ev):
    rep = pkg_runner.ReplicationResult(
        rep=0, iterations=259, incumb_x=x, incumb_est=381.8536412,
        optimal=True, lp_count=388, unique_omegas=3,
        pool_sizes=dict(omega=3, lam=14, sigma=14, cuts=6),
        time_total=12.3456789, time_setup=0.25, quad_scalar=0.0123,
        cuts_active=6)
    rep.eval = pkg_eval.EvalResult(*ev)
    return pkg_runner.RunResult(problem="LANDS", replications=[rep])


def test_result_files_match_jax(tmp_path):
    import stochasticdecomposition_torch.core.evaluate as pev
    import stochasticdecomposition_torch.runner as prun
    import stochasticdecomposition_tpu.runner as jrun
    from stochasticdecomposition_torch.utils import io as pio
    from stochasticdecomposition_tpu.prob import decompose as jdec
    from stochasticdecomposition_tpu.runner import attach_stoc as jatt
    from stochasticdecomposition_tpu.utils import io as jio
    from stochasticdecomposition_tpu.models.instances import load_instance

    x = np.array([2.5, 4.0, 3.3333333, 0.1666667])
    ev = (382.11345, 0.42, 11776, 381.42255, 382.80435, 0.00361615, 0)
    psp = port_problem("lands")
    core, tim, stoc = load_instance("lands")
    jsp = jatt(jdec(core, tim, stoc), stoc)
    pio.write_all(str(tmp_path / "port"), _results(prun, pev, x, ev),
                  sp=psp, max_iter=5000)
    jio.write_all(str(tmp_path / "jax"), _results(jrun, jeval, x, ev),
                  sp=jsp, max_iter=5000)
    for f in ("detailedResults.csv", "incumb.dat", "results.jsonl"):
        a = (tmp_path / "port" / f).read_text()
        assert a == (tmp_path / "jax" / f).read_text(), f
    rec = json.loads((tmp_path / "port" / "results.jsonl").read_text())
    assert rec["eval"]["count"] == 11776
    a = (tmp_path / "port" / "summary.dat").read_text().splitlines()
    b = (tmp_path / "jax" / "summary.dat").read_text().splitlines()
    assert len(a) == len(b)
    diff = [(p, q) for p, q in zip(a, b) if p != q]
    assert len(diff) == 1 and diff[0][0].startswith("Algorithm") and \
        diff[0][0].endswith("(PyTorch)")
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_dropped_lanes_are_counted_and_bounded():
    """Lanes that do not solve are left out and counted; above 1 % of the
    lanes drawn the evaluation raises (evaluate.c:70-76)."""
    ps = _port_solver("lands", EVAL_BATCH=100, EVAL_MIN_ITER=150)

    def one_dropped(x, gen=None, w_raw=None):
        return 10.0, 5.0, 99, 100

    with pytest.warns(RuntimeWarning, match="dropped 2/200"):
        ev = evaluate(ps.pa, ps.spec, ps.cfg, np.zeros(4), max_obs=150,
                      eval_batch_fn=one_dropped)
    assert ev.count == 198 and ev.dropped == 2
    with pytest.raises(RuntimeError, match="dropped 10/100"):
        evaluate(ps.pa, ps.spec, ps.cfg, np.zeros(4), max_obs=50,
                 eval_batch_fn=lambda x, gen=None, w_raw=None: (1.0, 0.0,
                                                                90, 100))


def test_run_evaluates_the_incumbent_on_cpu():
    sp = port_problem("lands")
    solver = SDSolver(sp, SDConfig(MAX_ITER=600, EVAL_BATCH=256),
                      device="cpu")
    result = solver.run()
    (r,) = result.replications
    assert r.optimal and isinstance(r.eval, EvalResult)
    ev = r.eval
    assert ev.count >= solver.cfg.EVAL_MIN_ITER and ev.dropped == 0
    assert 3.92 * ev.stdev <= solver.cfg.EVAL_ERROR * abs(ev.mean - float(
        solver.pa.c1 @ torch.as_tensor(r.incumb_x)))
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    exact = exact_objective_fn(solver.pa, outs, probs)(r.incumb_x)
    assert abs(ev.mean - exact) / abs(exact) <= 0.01
    assert ev.ci_low < ev.mean < ev.ci_high
    # Several replications with the compromise: every replication, the
    # compromise and the average are evaluated (EVAL_SEED[rep], then
    # EVAL_SEED[0]).
    many = SDSolver(sp, SDConfig(MAX_ITER=64, MULTIPLE_REP=2,
                                 COMPROMISE_PROB=True, EVAL_BATCH=256),
                    device="cpu").run()
    for ev in [r.eval for r in many.replications] + [
            many.compromise_eval, many.average_eval]:
        assert isinstance(ev, EvalResult) and ev.dropped == 0
        assert ev.ci_low < ev.mean < ev.ci_high


def test_evaluate_x_follows_eval_batch():
    """``SDSolver.evaluate_x`` keeps its batch function across calls and
    builds it again when EVAL_BATCH changes; the lanes counted are the lanes
    solved."""
    ps = _port_solver("lands", EVAL_BATCH=32)
    ev = ps.evaluate_x(ps.mean_sol, max_obs=32)
    fn = ps.eval_batch_fn
    assert ev.count + ev.dropped == 32
    assert ps.evaluate_x(ps.mean_sol, max_obs=32) == ev
    assert ps.eval_batch_fn is fn
    ps.cfg.EVAL_BATCH = 48
    ev = ps.evaluate_x(ps.mean_sol, max_obs=48)
    assert ev.count + ev.dropped == 48 and ps.eval_batch_fn is not fn
