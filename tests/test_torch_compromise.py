"""The compromise decision of several replications: the port against the
JAX package on the same ``BatchEntry`` lists.

- Entries from the port's own ``SDSolver.run`` (three replications of lands;
  two of feastest in feasibility mode, so feasibility cuts are in the batch
  problem) go through both packages' ``solve_compromise``: the compromise
  decision to 1e-7, the average exactly, and ``run``'s compromise is the
  one ``solve_compromise`` gives.
- ``_return_obj`` on a tightened box: x and objective to 1e-7, ``converged``
  equal.
- The integer compromise (MIQP on intcaplike, two replications): the same
  integral point from the same number of branch-and-bound nodes.
- Entries made by the JAX package (its own steps, its ``BatchEntry``)
  carried across with ``interop.batch_entry_from_numpy``: the same
  compromise to 1e-7.
- The compromise of two short stormlike replications (``stormlike_b8`` of
  chip_smoke.py, two replications of 6 steps at SAMPLE_INCREMENT 8, saved
  from the card in ``tests/data/stormlike_b8_entries.npz``): the JAX
  package's IPM stalls on it and ends uncertified at its cap of 100
  iterations (scripts/torch_compromise_storm.py).  The port, whose dual
  step takes the clamped barrier weights (``consistent_clamp``), certifies
  it before the cap, meets the first-stage rows and bounds to 1e-6, and
  agrees with the JAX package's solve of the same entries (its last
  iterate): objective to 1e-9 relative, decision to STORM_X_TOL.  The
  decision is not held tighter because the JAX point is uncertified and
  the proximal weight (~0.0013) fixes the decision only loosely: on the
  CPU at 1-8 threads the two decisions differed by up to 3.5e-5 and the
  JAX decision moved by 1.8e-5 with its thread count.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

from stochasticdecomposition_torch.config import MASTER_MIQP, SDConfig
from stochasticdecomposition_torch.core import compromise as pc
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.interop import batch_entry_from_numpy
from stochasticdecomposition_torch.models.suite import load_suite_instance
from stochasticdecomposition_torch.prob import attach_stoc, decompose
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.core import compromise as jc
from stochasticdecomposition_tpu.core.state import stage_problem as jax_stage
from stochasticdecomposition_tpu.models.suite import (
    load_suite_instance as jax_load_suite,
)
from stochasticdecomposition_tpu.prob import decompose as jax_decompose
from torch_common import CPU, jax_init, jax_solver, port_problem

TOL = 1e-7
STORM_X_TOL = 2e-4
SMALL = dict(MAX_OMEGA=128, MAX_LAMBDA=512, MAX_SIGMA=512)


def _port_run(name, reps, **cfg):
    solver = SDSolver(port_problem(name),
                      SDConfig(EVAL_FLAG=False, MULTIPLE_REP=reps,
                               COMPROMISE_PROB=True, **SMALL, **cfg),
                      device="cpu")
    return solver, solver.run()


def _jax_entries(result):
    return [jc.BatchEntry(**dataclasses.asdict(r.batch_entry))
            for r in result.replications]


@pytest.fixture(scope="module")
def lands_runs():
    """Three replications of lands in the port, and the JAX solver."""
    return (*_port_run("lands", 3, MAX_ITER=80),
            jax_solver("lands", MAX_ITER=80, **SMALL))


@pytest.mark.parametrize("name", ["lands", "feastest"])
def test_compromise_matches_jax(name, lands_runs):
    if name == "lands":
        solver, result, js = lands_runs
    else:
        solver, result = _port_run(name, 2, MAX_ITER=40)
        js = jax_solver(name, MAX_ITER=40, **SMALL)
    entries = [r.batch_entry for r in result.replications]
    if name == "feastest":
        assert all(e.fcut_mask.any() for e in entries)
    cx, ax = pc.solve_compromise(solver.pa, entries)
    np.testing.assert_array_equal(cx, result.compromise_x)
    np.testing.assert_array_equal(ax, result.average_x)
    jx, jax_avg = jc.solve_compromise(js.pa, js.cfg, _jax_entries(result))
    np.testing.assert_allclose(cx, jx, rtol=0, atol=TOL)
    np.testing.assert_array_equal(ax, jax_avg)


def test_return_obj_on_a_tightened_box(lands_runs):
    solver, result, js = lands_runs
    entries = [r.batch_entry for r in result.replications]
    # Cap the first column one unit below the compromise decision.
    hi = solver.pa.u1.numpy().copy()
    hi[0] = max(result.compromise_x[0] - 1.0, 0.0)
    lo = solver.pa.l1.numpy()
    x, obj, ok = pc.solve_compromise(solver.pa, entries, x_lo=lo, x_hi=hi,
                                     _return_obj=True)
    jxx, jobj, jok = jc.solve_compromise(js.pa, js.cfg, _jax_entries(result),
                                         x_lo=lo, x_hi=hi, _return_obj=True)
    assert ok and jok
    np.testing.assert_allclose(x, jxx, rtol=0, atol=TOL)
    assert abs(obj - jobj) <= TOL * max(1.0, abs(jobj))
    assert np.all(x <= hi + 1e-7)


def _counting(module, monkeypatch):
    calls = []
    orig = module.solve_compromise

    def counted(*a, **kw):
        calls.append(kw.get("_return_obj", False))
        return orig(*a, **kw)

    monkeypatch.setattr(module, "solve_compromise", counted)
    return calls


def test_integer_compromise_matches_jax_tree(monkeypatch):
    port_nodes = _counting(pc, monkeypatch)
    solver, result = _port_run("intcaplike", 2, MAX_ITER=40, MIN_ITER=20,
                               MASTER_TYPE=MASTER_MIQP)
    cx = result.compromise_x
    assert np.array_equal(cx, np.round(cx))
    js = jax_solver("intcaplike", MAX_ITER=40, MIN_ITER=20,
                    MASTER_TYPE=MASTER_MIQP, **SMALL)
    jax_nodes = _counting(jc, monkeypatch)
    jx, jax_avg = jc.solve_compromise_mip(js.pa, js.cfg,
                                          _jax_entries(result))
    np.testing.assert_array_equal(cx, jx)
    np.testing.assert_array_equal(result.average_x, jax_avg)
    assert len(port_nodes) == len(jax_nodes) > 0
    assert all(port_nodes)


def test_jax_batch_entries_carried_across(lands_runs):
    js = lands_runs[2]
    jentries = []
    for seed in (0, 1):
        st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                      jax.random.PRNGKey(seed))
        for _ in range(20):
            st = js.step(st)
        jentries.append(jc.batch_entry_from_state(st))
    jx, jax_avg = jc.solve_compromise(js.pa, js.cfg, jentries)
    pa = stage_problem(port_problem("lands"), CPU)
    entries = [batch_entry_from_numpy(dataclasses.asdict(e))
               for e in jentries]
    cx, ax = pc.solve_compromise(pa, entries)
    np.testing.assert_allclose(cx, jx, rtol=0, atol=TOL)
    np.testing.assert_array_equal(ax, jax_avg)
    with pytest.raises(KeyError, match="cut_beta"):
        batch_entry_from_numpy({k: v for k, v in
                                dataclasses.asdict(jentries[0]).items()
                                if k != "cut_beta"})


def test_storm_compromise_certifies_within_the_cap(monkeypatch):
    data = np.load(Path(__file__).parent / "data" /
                   "stormlike_b8_entries.npz")
    entries = [batch_entry_from_numpy(
        {f.name: data[f"r{i}_{f.name}"]
         for f in dataclasses.fields(pc.BatchEntry)}) for i in (0, 1)]
    core, tim, stoc = load_suite_instance("stormlike")
    pa = stage_problem(attach_stoc(decompose(core, tim, stoc), stoc), CPU)
    iters = []
    solve_qp = pc.solve_qp

    def recorded(*a, **kw):
        res = solve_qp(*a, **kw)
        iters.append((kw["max_iter"], res.iters))
        return res

    monkeypatch.setattr(pc, "solve_qp", recorded)
    cx, ax = pc.solve_compromise(pa, entries)
    assert iters[0][0] == 100 and iters[0][1] < 100
    A, b1, sense = pa.A1.numpy(), pa.b1.numpy(), pa.sense1.numpy()
    r = A @ cx - b1
    worst = np.where(sense == 0, np.abs(r), np.where(sense > 0, -r, r))
    assert np.max(worst) <= 1e-6
    assert np.min(cx - pa.l1.numpy()) >= -1e-6
    assert np.max(cx - pa.u1.numpy()) <= 1e-6

    x, obj, ok = pc.solve_compromise(pa, entries, _return_obj=True)
    np.testing.assert_array_equal(x, cx)
    jpa = jax_stage(jax_decompose(*jax_load_suite("stormlike")))
    jentries = [jc.BatchEntry(**dataclasses.asdict(e)) for e in entries]
    jx, jobj, _ = jc.solve_compromise(jpa, None, jentries, _return_obj=True)
    assert ok and abs(obj - jobj) <= 1e-9 * abs(jobj)
    np.testing.assert_allclose(x, jx, rtol=0, atol=STORM_X_TOL)
