"""Technology-matrix (random C) randomness: the port against the JAX package.

The instances are the JAX package's own random-C cases
(``parse_synthetic(seed=11, n_rv=2, support=2, rand_C=2)`` of
tests/test_sdcut.py and ``parse_synthetic(seed=2, ..., n2=6, m2=4)`` of
tests/test_e2e.py), generated by each package's copy of the generator.  They
reach the three branches that RHS-only instances never run: the delta_piC
term of the height table, the delta_piC fills of the stochastic updates and
the C_cols_rand part of the cut's accumulation.

- 30 SD steps on injected draws: iterates, estimates and the delta tables
  to 1e-7 relative, pool and cut counts exact.
- One cut from the JAX state after 5 and 20 steps, at the candidate and at
  a point whose random-C columns are moved off zero (so the delta_piC term
  of H is live on both instances): istar exact, alpha, beta and heights to
  1e-9 relative.
- A run of the port to the certified stop on the CPU: exact gap of the
  incumbent against the extensive-form optimum at most 0.01.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.cuts import add_cut, form_cut
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.step import make_step
from stochasticdecomposition_torch.core.update import (
    calc_omega, stochastic_updates, warm_solve_subproblem,
)
from stochasticdecomposition_torch.models.extensive import (
    enumerate_scenarios, exact_objective_fn, solve_extensive_form,
)
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.core import cuts as jcuts
from stochasticdecomposition_tpu.core import update as jupd
from torch_common import CPU, RANDC, jax_init, jax_solver, jax_states, \
    jax_step_draw, port_problem, to_port_state

RTOL = 1e-7
TOL = 1e-3          # SDConfig.TOLERANCE
CUT = dict(dual_stability=True, pi_eval_start=0, pi_cycle=1, scan_len=256)
NAMES = sorted(RANDC)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


@pytest.mark.parametrize("name", NAMES)
def test_30_steps_match_jax(name):
    js = jax_solver(name, MAX_ITER=64)
    pa = stage_problem(port_problem(name), CPU)
    assert pa.C_cols_rand.shape[0] == 2 and pa.rv_C_rows.shape[0] == 2
    step = make_step(pa, None, SDConfig(MAX_ITER=64, EVAL_FLAG=False))
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(1))
    ps = to_port_state(st)
    for i in range(30):
        w = jax_step_draw(js, st)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        for f in ("candid_x", "incumb_x", "incumb_est", "candid_est",
                  "quad_scalar", "delta_pib", "delta_piC", "sigma_pib",
                  "sigma_piC", "cut_alpha", "cut_beta", "pi_ratio"):
            assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (i, f)
        for f in ("omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt"):
            assert getattr(ps, f) == int(getattr(st, f)), (i, f)
        assert int(ps.cut_mask.sum()) == int(jnp.sum(st.cut_mask)), i
        assert ps.dual_stable == bool(st.dual_stable), i
    # The random-C delta table was filled, not left at zero.
    assert float(torch.amax(torch.abs(ps.delta_piC))) > 0.0


def _jax_one_cut(pa, state, w, x, k):
    state, o_idx, new_o = jupd.calc_omega(state, w, TOL)
    res, state = jupd.warm_solve_subproblem(pa, state, x,
                                            state.omega_vals[o_idx])
    state, _ = jupd.stochastic_updates(pa, state, res, o_idx, new_o, k, TOL)
    parts, state = jcuts.form_cut(pa, state, x, k, **CUT)
    state, slot = jcuts.add_cut(pa, state, parts, k, incumbent=False, tol=TOL)
    return parts, state, slot


def _port_one_cut(pa, state, w, x, k):
    state = state._replace(k=k)
    state, o_idx, new_o = calc_omega(state, w, TOL)
    res, state = warm_solve_subproblem(pa, state, x, state.omega_vals[o_idx])
    state, _ = stochastic_updates(pa, state, res, o_idx, new_o, k, TOL)
    parts, state = form_cut(pa, state, x, k, **CUT)
    state, slot = add_cut(pa, state, parts, k, incumbent=False, tol=TOL)
    return parts, state, slot


@functools.lru_cache(maxsize=None)
def _setup(name):
    js = jax_solver(name, MAX_ITER=64)
    states, draws = jax_states(js, 20)
    return js, states, draws, stage_problem(port_problem(name), CPU)


@pytest.mark.parametrize("point", ["candidate", "shifted"])
@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("name", NAMES)
def test_one_cut_matches_jax(name, k, point):
    js, states, draws, pa = _setup(name)
    st = states[k]
    w = np.asarray(draws[k] if k < len(draws) else draws[-1]) - \
        np.asarray(js.pa.omega_mean)
    x = np.array(st.candid_x)
    if point == "shifted":
        # Move the random-C columns off their bound: the x'delta_piC term.
        x[np.asarray(js.pa.C_cols_rand)] += 1.5
    k1 = int(st.k) + 1
    jparts, jst, jslot = jax.jit(_jax_one_cut)(
        js.pa, st, jnp.asarray(w), jnp.asarray(x), jnp.int32(k1))
    parts, pst, slot = _port_one_cut(pa, to_port_state(st),
                                     torch.as_tensor(w), torch.as_tensor(x),
                                     k1)

    for f in ("omega_cnt", "lambda_cnt", "sigma_cnt"):
        assert getattr(pst, f) == int(getattr(jst, f)), f
    assert parts.found == bool(jparts.found)
    np.testing.assert_array_equal(parts.istar.numpy(),
                                  np.asarray(jparts.istar))
    assert _rel(parts.alpha, jparts.alpha) <= 1e-9
    assert _rel(parts.beta, jparts.beta) <= 1e-9
    o = int(jst.omega_cnt)
    assert _rel(parts.height[:o], jparts.height[:o]) <= 1e-9
    assert slot == int(jslot)
    np.testing.assert_array_equal(pst.cut_mask.numpy(),
                                  np.asarray(jst.cut_mask))
    assert _rel(pst.cut_beta, jst.cut_beta) <= 1e-9
    assert _rel(pst.delta_piC, jst.delta_piC) <= 1e-9
    assert _rel(pst.pi_ratio, jst.pi_ratio) <= 1e-9
    # The random-C term reaches the cut's beta on the random columns.
    cr = np.asarray(js.pa.C_cols_rand)
    assert np.any(np.asarray(jparts.beta)[cr] != 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_reaches_certified_stop_on_cpu(name):
    sp = port_problem(name)
    solver = SDSolver(sp, SDConfig(MAX_ITER=600, EVAL_FLAG=False),
                      device="cpu")
    res = solver.solve_replication(0)
    assert res.optimal and res.iterations < 600
    assert res.cuts_formed >= res.iterations
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    ef_obj, _ = solve_extensive_form(sp, outs, probs)
    exact = exact_objective_fn(solver.pa, outs, probs)(res.incumb_x)
    assert abs(exact - ef_obj) / abs(ef_obj) <= 0.01
