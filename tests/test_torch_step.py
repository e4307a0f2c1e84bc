"""The SD iteration and the stopping test of both packages, step by step.

30 steps of lands and of pgp2like at MAX_ITER=64: the test draws each
observation as the JAX step does (the same key split and sample_omega
call) and injects it into the port; after every step the iterates, the
proximal scalar and the pool counts must agree.  The bootstrap full test is
held against JAX's on the same resampling draws (JAX's own categorical
draws, injected into the port) over a sweep of EPSILON.  And the port runs
lands to the certified stop on the CPU.

Tolerances: iterates and estimates 1e-7 relative; counts exact; verdicts
equal; the certified stop's exact gap at most 0.01 (the same bound the card
run holds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.step import make_step
from stochasticdecomposition_torch.core.stopping import full_test
from stochasticdecomposition_torch.models.extensive import (
    enumerate_scenarios, exact_objective_fn,
)
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from stochasticdecomposition_tpu.core.stopping import make_full_test
from torch_common import CPU, jax_init, jax_solver, jax_step_draw, \
    port_problem, to_port_state

RTOL = 1e-7
STEPS = 30
OPTIMA = {"lands": 382.0222, "pgp2like": 113.3000}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _run_both(name):
    js = jax_solver(name, MAX_ITER=64)
    pa = stage_problem(port_problem(name), CPU)
    step = make_step(pa, None, SDConfig(MAX_ITER=64, EVAL_FLAG=False))
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(1))
    ps = to_port_state(st)
    for i in range(STEPS):
        w = jax_step_draw(js, st)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        for f in ("candid_x", "incumb_x", "incumb_est", "quad_scalar"):
            assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (i, f)
        for f in ("omega_cnt", "lambda_cnt", "sigma_cnt"):
            assert getattr(ps, f) == int(getattr(st, f)), (i, f)
        assert int(ps.cut_mask.sum()) == int(jnp.sum(st.cut_mask)), i
        assert ps.k == int(st.k) == i + 1
    return js, pa, st, ps


def _jax_boot_logits(st):
    """The categorical logits make_full_test resamples from."""
    probs = st.omega_w.astype(jnp.float64)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    O = probs.shape[0]
    logits = jnp.where(jnp.arange(O) < st.omega_cnt,
                       jnp.log(jnp.maximum(probs, 1e-300)), -jnp.inf)
    return logits


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
def test_30_steps_match_jax(name):
    js, pa, st, ps = _run_both(name)
    if name != "lands":
        return
    # The bootstrap full test on the state after 30 steps, on JAX's own
    # resampling draws, over EPSILON values around the verdict's switch.
    key = jax.random.PRNGKey(5)
    logits = _jax_boot_logits(st)
    keys = jax.random.split(key, 50)
    draws = jax.vmap(lambda rk: jax.random.categorical(
        rk, logits, shape=(64,)))(keys)
    verdicts = []
    for eps in (1e-3, 3e-2, 1e-1, 1.0):
        jcfg = JaxConfig(MAX_ITER=64, EVAL_FLAG=False, EPSILON=eps)
        cfg = SDConfig(MAX_ITER=64, EVAL_FLAG=False, EPSILON=eps)
        want = bool(make_full_test(js.pa, jcfg, 64)(st, key))
        got = full_test(pa, cfg, ps, torch.as_tensor(np.array(draws)))
        assert got == want, eps
        verdicts.append(got)
    assert verdicts[0] is False and verdicts[-1] is True


def test_lands_reaches_certified_stop_on_cpu():
    sp = port_problem("lands")
    solver = SDSolver(sp, SDConfig(MAX_ITER=600, EVAL_FLAG=False),
                      device="cpu")
    res = solver.solve_replication(0)
    assert res.optimal and res.iterations < 600
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    exact = exact_objective_fn(solver.pa, outs, probs)(res.incumb_x)
    assert abs(exact - OPTIMA["lands"]) / OPTIMA["lands"] <= 0.01


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
def test_staged_problem_and_fresh_state_match_jax(name):
    """stage_problem, derive_capacities and init_state give the JAX
    package's values (exact), and problem_from_numpy carries JAX's
    ProblemArrays across unchanged."""
    from stochasticdecomposition_torch.core.state import (
        derive_capacities, init_state,
    )
    from stochasticdecomposition_torch.interop import problem_from_numpy
    from torch_common import jax_fields

    js = jax_solver(name, MAX_ITER=64)
    sp = port_problem(name)
    cfg = SDConfig(MAX_ITER=64, EVAL_FLAG=False)
    pa = stage_problem(sp, CPU)
    carried = problem_from_numpy(jax_fields(js.pa))
    for f in pa._fields:
        a, b = getattr(pa, f), getattr(carried, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f
    caps = derive_capacities(sp, cfg)
    assert tuple(caps) == tuple(js.caps)
    x0 = np.array(js.mean_sol)
    st = init_state(pa, caps, cfg, x0)
    ref = to_port_state(jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                                 jax.random.PRNGKey(0)))
    for f in st._fields:
        a, b = getattr(st, f), getattr(ref, f)
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype, f
            assert torch.equal(a, b), f
        else:
            assert a == b, f
    from stochasticdecomposition_torch.runner import mean_value_solution
    np.testing.assert_allclose(mean_value_solution(sp, CPU), x0, atol=1e-9)
