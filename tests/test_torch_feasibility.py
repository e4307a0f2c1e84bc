"""Feasibility mode (resolveInfeasibility, cuts.c:398-567): the port against
the JAX package on ``feastest``, whose mean-value solution makes the
subproblem infeasible under the d = 6 observation.

- Both packages step on the same injected draws to the first infeasible
  subproblem, then resolve it: the feasibility cut pool and slots, the
  candidate, the incumbent, the rounds, ``cut_ok`` and the stored cuts agree
  (1e-9 relative, counts exact).  So do the next steps after it.
- A run of the port on the CPU (MAX_ITER 300, as the JAX package's own
  test): feasibility mode triggers, the incumbent meets the induced
  constraint x1 + x2 >= 6 and its exact gap is under 0.01.  feastest has no
  certified stop in either package (ROADMAP C): the bootstrap lower bound
  leaves out the feasibility cuts.
- The evaluator raises on the mean-value solution, where 30 % of the lanes
  are infeasible.
"""

import jax
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.feasibility import (
    resolve_infeasibility,
)
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.step import make_step, make_substeps
from stochasticdecomposition_torch.models.extensive import (
    enumerate_scenarios, exact_objective_fn, solve_extensive_form,
)
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.core.feasibility import (
    resolve_infeasibility as jax_resolve,
)
from torch_common import CPU, jax_init, jax_solver, jax_step_draw, \
    port_problem, to_port_state

TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _assert_states_agree(ps, st, where):
    for f in ("candid_x", "incumb_x", "candid_est", "incumb_est",
              "quad_scalar", "fcut_alpha", "fcut_beta", "cut_alpha",
              "cut_beta", "sigma_pib"):
        assert _rel(getattr(ps, f), getattr(st, f)) <= TOL, (where, f)
    for f in ("k", "feas_cnt", "omega_cnt", "lambda_cnt", "sigma_cnt",
              "lp_cnt", "i_cut_updt"):
        assert getattr(ps, f) == int(getattr(st, f)), (where, f)
    for f in ("sp_feas", "cut_ok", "incumb_chg", "infeas_incumb",
              "opt_mode"):
        assert getattr(ps, f) == bool(getattr(st, f)), (where, f)
    np.testing.assert_array_equal(ps.fcut_mask.numpy(),
                                  np.asarray(st.fcut_mask), err_msg=where)
    np.testing.assert_array_equal(ps.cut_mask.numpy(),
                                  np.asarray(st.cut_mask), err_msg=where)
    assert ps.f_updt == tuple(int(v) for v in np.asarray(st.f_updt)), where


# Seed 5 meets the infeasible subproblem at k = 1, with a ray-only pool
# (the cut is skipped); seed 0 at k = 3.
@pytest.mark.parametrize("seed", [0, 5])
def test_resolve_infeasibility_matches_jax(seed):
    js = jax_solver("feastest", MAX_ITER=50)
    pa = stage_problem(port_problem("feastest"), CPU)
    cfg = SDConfig(MAX_ITER=50, EVAL_FLAG=False)
    step = make_step(pa, None, cfg)
    substeps = make_substeps(pa, cfg)
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                  jax.random.PRNGKey(seed))
    ps = to_port_state(st)
    for _ in range(20):
        w = jax_step_draw(js, st)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        assert ps.sp_feas == bool(st.sp_feas)
        if not ps.sp_feas:
            break
    assert not ps.sp_feas, "expected an infeasible subproblem"
    assert (ps.k, ps.cut_ok) == ((1, False) if seed == 5 else (3, True))
    n_cuts = int(ps.cut_mask.sum())
    cut_cnt = ps.cut_cnt

    st, ja, jb = jax_resolve(js.pa, st, js.cfg, js.substeps, [], [])
    ps, pa_, pb_ = resolve_infeasibility(pa, ps, cfg, substeps, [], [])
    assert len(pa_) == len(ja) > 0
    assert _rel(pa_, ja) <= TOL and _rel(np.stack(pb_), np.stack(jb)) <= TOL
    _assert_states_agree(ps, st, "resolved")
    assert ps.sp_feas and ps.feas_cnt > 0
    # The interrupted cut was formed (and counted: one argmax call).
    assert ps.cut_cnt == cut_cnt + 1
    assert int(ps.cut_mask.sum()) >= n_cuts + int(ps.cut_ok)

    # The run goes on in step with the JAX package after the resolve.
    for i in range(5):
        w = jax_step_draw(js, st)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        if not ps.sp_feas:
            st, ja, jb = jax_resolve(js.pa, st, js.cfg, js.substeps, ja, jb)
            ps, pa_, pb_ = resolve_infeasibility(pa, ps, cfg, substeps, pa_,
                                                 pb_)
        _assert_states_agree(ps, st, f"after {i + 1}")


def test_feastest_run_on_cpu():
    sp = port_problem("feastest")
    solver = SDSolver(sp, SDConfig(MAX_ITER=300, EVAL_FLAG=False),
                      device="cpu")
    res = solver.solve_replication(0)
    assert res.feas_rounds > 0, "expected feasibility mode to trigger"
    assert res.iterations == 300
    assert res.incumb_x.sum() >= 6.0 - 1e-6
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    ef_obj, _ = solve_extensive_form(sp, outs, probs)
    exact = exact_objective_fn(solver.pa, outs, probs)(res.incumb_x)
    assert abs(exact - ef_obj) / abs(ef_obj) <= 0.01


def test_evaluate_raises_on_dropped_lanes():
    solver = SDSolver(port_problem("feastest"),
                      SDConfig(MAX_ITER=50, EVAL_FLAG=False), device="cpu")
    with pytest.raises(RuntimeError, match="dropped"):
        solver.evaluate_x(solver.mean_sol)
