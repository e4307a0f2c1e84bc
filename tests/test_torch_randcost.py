"""Random cost coefficients (the v2.0 path: randCost.c and the basis
branches of stocUpdate.c): the port against the JAX package.

The instances are the JAX package's own random-cost cases
(``parse_synthetic(seed=21, n_rv=1, support=2, rand_d=2, n2=6, m2=4)`` and
the mixed ``seed=33, n_rv=2, support=2, rand_d=1, n2=5, m2=4`` of
tests/test_randcost.py), generated by each package's copy of the generator.

- 30 SD steps on injected draws: iterates and pools to 1e-7 relative; the
  basis pool's count, ``basis_ck``, ``basis_cstat`` and the [B, O]
  ``obs_feas`` table exact.
- One cut from the JAX state after 20 steps: istar exact, alpha and beta
  to 1e-9 relative.
- The blockwise ``triple_argmax_randcost`` against the JAX package's and
  against the materialized [B, O] table (``height_table_randcost``), on
  the pool the run built and on a pool filled to 60 bases (repeated rows
  make ties), with the default block and blocks of 1 and 7 bases (many
  blocks): heights to 1e-12 against JAX and exactly against the
  materialized table; indices equal to JAX's, and the materialized table's
  height at them equal to the max.
- ``reform_sums_randcost`` with the lb correction on the same bootstrap
  counts: 1e-9.
- 8 batched steps at SAMPLE_INCREMENT 4 (the observations pooled one at a
  time): as the 30 steps.
- A run of the port on the CPU to the certified stop on ``fleetminilike``
  (81 enumerable scenarios): exact gap under 0.01.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.cuts import add_cut, form_cut
from stochasticdecomposition_torch.core.randcost import (
    height_table_randcost, reform_sums_randcost, triple_argmax_randcost,
)
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.step import make_step, problem_path
from stochasticdecomposition_torch.core.stopping import with_lb
from stochasticdecomposition_torch.core.update import (
    calc_omega, warm_solve_subproblem,
)
from stochasticdecomposition_torch.models.extensive import (
    enumerate_scenarios, exact_objective_fn, solve_extensive_form,
)
from stochasticdecomposition_torch.models.suite import load_suite_instance
from stochasticdecomposition_torch.prob import attach_stoc, decompose
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.core import cuts as jcuts
from stochasticdecomposition_tpu.core import randcost as jrc
from stochasticdecomposition_tpu.core import update as jupd
from torch_common import CPU, RANDD, jax_init, jax_solver, jax_states, \
    jax_step_draw, port_problem, to_port_state

RTOL = 1e-7
TOL = 1e-3          # SDConfig.TOLERANCE
CUT = dict(dual_stability=True, pi_eval_start=0, pi_cycle=1, scan_len=256)
NAMES = sorted(RANDD)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _assert_states_match(ps, st, tag):
    for f in ("candid_x", "incumb_x", "incumb_est", "candid_est",
              "quad_scalar", "sigma_pib", "delta_pib", "cut_alpha",
              "cut_beta", "basis_pidet", "basis_phi", "basis_gbar",
              "basis_psi", "basis_mub"):
        assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (tag, f)
    for f in ("k", "omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt",
              "basis_cnt"):
        assert getattr(ps, f) == int(getattr(st, f)), (tag, f)
    for f in ("basis_ck", "basis_cstat", "basis_rstat", "basis_present",
              "basis_sigma0", "basis_sigma_idx", "basis_feas", "obs_feas",
              "cut_mask"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(st, f)),
                                      err_msg=f"{tag} {f}")


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The JAX solver (one compiled step per instance), its states after
    0..20 steps with their draws, and the port's staged problem."""
    js = jax_solver(name, MAX_ITER=64)
    states, draws = jax_states(js, 20, seed=2)
    return js, states, draws, stage_problem(port_problem(name), CPU)


@pytest.mark.parametrize("name", NAMES)
def test_30_steps_match_jax(name):
    js, _, _, pa = _setup(name)
    assert pa.rv_d_cols.shape[0] == RANDD[name]["rand_d"]
    step = make_step(pa, None, SDConfig(MAX_ITER=64, EVAL_FLAG=False))
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(1))
    ps = to_port_state(st)
    for i in range(30):
        w = jax_step_draw(js, st)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        _assert_states_match(ps, st, i)
    assert ps.basis_cnt >= 1


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
    path = problem_path(pa)
    state, _ = path.updates(pa, state, res, o_idx, new_o, k, TOL)
    parts, state = form_cut(pa, state, x, k, **CUT, argmax=path.argmax,
                            accumulate=path.accumulate)
    state, slot = add_cut(pa, state, parts, k, incumbent=False, tol=TOL)
    return parts, state, slot


@pytest.mark.parametrize("name", NAMES)
def test_one_cut_matches_jax(name):
    js, states, draws, pa = _setup(name)
    st = states[19]
    w = np.asarray(draws[19]) - np.asarray(js.pa.omega_mean)
    x = np.array(st.candid_x)
    k1 = int(st.k) + 1
    jparts, jst, jslot = jax.jit(_jax_one_cut)(
        js.pa, st, jnp.asarray(w), jnp.asarray(x), jnp.int32(k1))
    parts, pst, slot = _port_one_cut(pa, to_port_state(st),
                                     torch.as_tensor(w), torch.as_tensor(x),
                                     k1)
    assert pst.basis_cnt == int(jst.basis_cnt) >= 1
    assert parts.found == bool(jparts.found)
    np.testing.assert_array_equal(parts.istar.numpy(),
                                  np.asarray(jparts.istar))
    assert _rel(parts.alpha, jparts.alpha) <= 1e-9
    assert _rel(parts.beta, jparts.beta) <= 1e-9
    o = int(jst.omega_cnt)
    assert _rel(parts.height[:o], jparts.height[:o]) <= 1e-9
    assert slot == int(jslot)
    assert _rel(pst.cut_beta, jst.cut_beta) <= 1e-9


def _gates(state, k):
    ns_eff = k - math.floor(0.1 * float(k) + 1)
    return state.basis_ck <= ns_eff, state.basis_ck > ns_eff


def _filled(st, n, seed):
    """The JAX state with its basis pool filled to ``n`` bases drawn from
    the stored ones (sigma entries, presence, feasibility at random, some
    rows repeated so that heights tie): many blocks at a small block."""
    rng = np.random.default_rng(seed)
    B, nd = st.basis_sigma_idx.shape
    S = int(st.sigma_cnt)
    assert n <= B
    rows = rng.integers(0, int(st.basis_cnt), size=n)
    s0 = np.asarray(st.basis_sigma0).copy()
    s0[:n] = rng.integers(0, S, size=n)
    s0[n // 2:n] = s0[:n - n // 2]                 # repeated rows: ties
    sn = np.asarray(st.basis_sigma_idx).copy()
    sn[:n] = rng.integers(0, S, size=(n, nd))
    sn[n // 2:n] = sn[:n - n // 2]
    present = np.asarray(st.basis_present).copy()
    present[:n] = np.asarray(st.basis_present)[rows] | \
        (rng.random((n, nd)) < 0.5)
    present[n // 2:n] = present[:n - n // 2]
    ck = np.asarray(st.basis_ck).copy()
    ck[:n] = rng.integers(1, int(st.k) + 1, size=n)
    obs = np.asarray(st.obs_feas).copy()
    obs[:n] = rng.random((n, obs.shape[1])) < 0.8
    feas = np.asarray(st.basis_feas).copy()
    feas[:n] = rng.random(n) < 0.9
    return st._replace(
        basis_sigma0=jnp.asarray(s0), basis_sigma_idx=jnp.asarray(sn),
        basis_present=jnp.asarray(present), basis_ck=jnp.asarray(ck),
        obs_feas=jnp.asarray(obs), basis_feas=jnp.asarray(feas),
        basis_cnt=jnp.int32(n))


@pytest.mark.parametrize("pool", ["run", "filled"])
@pytest.mark.parametrize("block", [256, 1, 7])
@pytest.mark.parametrize("name", NAMES)
def test_blockwise_argmax_matches_jax_and_materialized(name, block, pool):
    js, states, _, pa = _setup(name)
    st = states[20] if pool == "run" else _filled(states[20], 60, 5)
    ps = to_port_state(st)
    x = ps.candid_x
    og, ng = _gates(ps, ps.k)
    got = triple_argmax_randcost(pa, ps, x, og, ng, block=block)
    want = jrc.triple_argmax_randcost(
        js.pa, st, st.candid_x, jnp.asarray(og.numpy()),
        jnp.asarray(ng.numpy()), block=block)
    H, valid, o_valid = height_table_randcost(pa, ps, x)
    np.testing.assert_array_equal(got[6].numpy(), o_valid.numpy())
    for j, gate in enumerate([torch.ones_like(og), og, ng]):
        Hm = torch.where(valid & gate[:, None], H, -1e300)
        i_got, h_got = got[2 * j], got[2 * j + 1]
        assert torch.equal(h_got, torch.amax(Hm, dim=0)), j
        assert torch.equal(Hm[i_got, torch.arange(Hm.shape[1])], h_got), j
        assert _rel(h_got, want[2 * j + 1]) <= 1e-12, j
        np.testing.assert_array_equal(i_got.numpy(),
                                      np.asarray(want[2 * j]), err_msg=j)


@pytest.mark.parametrize("name", NAMES)
def test_reform_cuts_matches_jax(name):
    js, states, _, _ = _setup(name)
    st = states[20]
    ps = to_port_state(st)
    pa = stage_problem(port_problem(name), CPU)
    rng = np.random.default_rng(7)
    O = ps.omega_vals.shape[0]
    counts = np.zeros((4, O), np.int64)
    for r in range(4):
        d = rng.integers(0, ps.omega_cnt, size=ps.k)
        np.add.at(counts[r], d, 1)
    alpha, beta, count = reform_sums_randcost(pa, ps,
                                              torch.as_tensor(counts))
    alpha = with_lb(pa, ps, alpha, count)
    for r in range(4):
        ja, jb = jrc.reform_cuts_randcost(js.pa, st,
                                          jnp.asarray(counts[r], jnp.int32))
        assert _rel(alpha[r], ja) <= 1e-9, r
        assert _rel(beta[r], jb) <= 1e-9, r


@pytest.mark.parametrize("name", NAMES)
def test_batched_steps_match_jax(name):
    kw = dict(MAX_ITER=32, SAMPLE_INCREMENT=4)
    js = jax_solver(name, **kw)
    pa = stage_problem(port_problem(name), CPU)
    step = make_step(pa, None, SDConfig(EVAL_FLAG=False, **kw))
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(4))
    ps = to_port_state(st)
    for i in range(8):
        w = jax_step_draw(js, st, 4)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        _assert_states_match(ps, st, i)
    assert ps.basis_cnt >= 1


def test_fleetminilike_reaches_certified_stop_on_cpu():
    core, tim, stoc = load_suite_instance("fleetminilike")
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    solver = SDSolver(sp, SDConfig(MAX_ITER=600, EVAL_FLAG=False),
                      device="cpu")
    res = solver.solve_replication(0)
    assert res.optimal and res.iterations < 600
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    assert len(probs) == 81
    ef_obj, _ = solve_extensive_form(sp, outs, probs)
    exact = exact_objective_fn(solver.pa, outs, probs)(res.incumb_x)
    assert abs(exact - ef_obj) / abs(ef_obj) <= 0.01
