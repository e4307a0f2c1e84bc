"""The LP, MILP and MIQP masters (master.c:41 with MASTER_TYPE 0/1/7): the
port against the JAX package.

- 30 SD steps of ``lands`` under the LP master on injected draws: iterates
  to 1e-7 relative, counts exact; at every step the master LP built from
  the same state has the JAX package's solution (1e-9) and takes the same
  number of simplex pivots as the JAX package's ``solve_lp`` on the same
  data.  LP mode has no incumbent cut slot (i_cut_idx -1) and reports the
  candidate as the incumbent.  (An LP-mode candidate sits at a vertex,
  where two dual vertices can give exactly the same height; the argmax then
  breaks the tie by the last bit of values the two packages round
  differently.  These steps run on PRNGKey 3, which meets no such tie in 40
  steps.)
- The same 30 steps on PRNGKey 1, which meets such a tie at k = 17: at
  every step where the packages part, they part only in the new cut, over
  observations where both chosen dual vertices are valid and reach the
  maximum height at the candidate, and the two cuts have the same height
  there (254.35728385313848); the port then resumes from the JAX state.
- ``make_mip_master`` on the same state as the JAX package's, under the
  MIQP and the MILP master of the deterministic ``intcaplike`` (demand a
  point mass at 2.4, JAX tests/test_milp.py:134): the same integral point,
  objective (1e-9), node and wave counts.  The MIQP run lands on the
  brute-force integer optimum.
- The MILP run's incumbent is integral, within 2 % of the EF-MIP optimum,
  and the LP and MILP masters stop at MAX_ITER with ``optimal`` false;
  MASTER_TYPE 7 on ``lands`` (no integer column) is the QP master.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import (
    MASTER_LP, MASTER_MILP, MASTER_MIQP, SDConfig,
)
from stochasticdecomposition_torch.core.bnb import make_mip_master
from stochasticdecomposition_torch.core.cuts import height_table
from stochasticdecomposition_torch.core.master import (
    build_and_solve_master_lp, master_lp_data,
)
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.step import make_step
from stochasticdecomposition_torch.models.instances import load_instance
from stochasticdecomposition_torch.prob import attach_stoc, decompose
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from stochasticdecomposition_tpu.core.bnb import (
    make_mip_master as jax_make_mip_master,
)
from stochasticdecomposition_tpu.core.master import (
    build_and_solve_master_lp as jax_master_lp,
)
from stochasticdecomposition_tpu.models.instances import (
    load_instance as jax_load_instance,
)
from stochasticdecomposition_tpu.ops.simplex import solve_lp as jax_solve_lp
from stochasticdecomposition_tpu.prob import decompose as jax_decompose
from stochasticdecomposition_tpu.runner import (
    SDSolver as JaxSolver, attach_stoc as jax_attach_stoc,
)
from torch_common import CPU, jax_init, jax_solver, jax_step_draw, \
    port_problem, to_port_state

RTOL = 1e-7
DEMANDS = np.array([1.0, 2.0, 3.0])
PROBS = np.array([0.3, 0.4, 0.3])


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _true_cost(x1, x2, demands=DEMANDS, probs=PROBS):
    """intcaplike's expected cost at an integer point: the recourse is
    greedy (y1 cost 2 < y2 cost 5 < slack 20)."""
    exp = 0.0
    for d, p in zip(demands, probs):
        y1 = min(x1, d)
        y2 = min(x2, d - y1)
        exp += p * (2.0 * y1 + 5.0 * y2 + 20.0 * (d - y1 - y2))
    return 3.0 * x1 + 2.0 * x2 + exp


def _brute_force(demands=DEMANDS, probs=PROBS):
    return min((_true_cost(a, b, demands, probs), (a, b))
               for a in range(6) for b in range(6) if a + b >= 1)


def _intcap(port, point_mass):
    core, tim, stoc = (load_instance if port else jax_load_instance)(
        "intcaplike")
    if point_mass:
        el = stoc.elements[0]
        el.values = np.array([2.4])
        el.probs = np.array([1.0])
    if port:
        return attach_stoc(decompose(core, tim, stoc), stoc)
    return jax_attach_stoc(jax_decompose(core, tim, stoc), stoc)


def test_lp_master_steps_match_jax():
    kw = dict(MAX_ITER=64, MASTER_TYPE=MASTER_LP)
    js = jax_solver("lands", **kw)
    pa = stage_problem(port_problem("lands"), CPU)
    cfg = SDConfig(EVAL_FLAG=False, **kw)
    step = make_step(pa, None, cfg)
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(3))
    ps = to_port_state(st)
    assert ps.i_cut_idx == int(st.i_cut_idx) == -1       # setup.c:113-119
    solve = jax.jit(jax_solve_lp, static_argnames="max_iter")
    master = jax.jit(jax_master_lp)
    for i in range(30):
        # The master LP of this state in both packages, before the step.
        k = ps.k + 1
        data = master_lp_data(pa, ps, k)
        mine = build_and_solve_master_lp(pa, ps, k)
        theirs = master(js.pa, st, jnp.int32(k))
        assert mine.ok and bool(theirs.ok)
        assert _rel(mine.x, theirs.x) <= 1e-9, i
        assert _rel(mine.obj, theirs.obj) <= 1e-9, i
        ref = solve(*(jnp.asarray(t.numpy()) for t in data),
                    max_iter=8 * (data[0].shape[0] + data[0].shape[1]) + 256)
        assert mine.iters == int(ref.iters), i

        w = jax_step_draw(js, st)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        for f in ("candid_x", "incumb_x", "candid_est", "incumb_est",
                  "cut_alpha", "cut_beta", "pi_cuts", "sigma_pib"):
            assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (i, f)
        for f in ("k", "omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt",
                  "i_cut_idx"):
            assert getattr(ps, f) == int(getattr(st, f)), (i, f)
        assert torch.equal(ps.incumb_x, ps.candid_x), i
        assert ps.i_cut_idx == -1
    assert ps.qp_iters > 0          # the master LPs' pivots


def test_lp_master_tie_is_a_valid_choice():
    kw = dict(MAX_ITER=64, MASTER_TYPE=MASTER_LP)
    js = jax_solver("lands", **kw)
    pa = stage_problem(port_problem("lands"), CPU)
    step = make_step(pa, None, SDConfig(EVAL_FLAG=False, **kw))
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(1))
    ps = to_port_state(st)
    ties = []
    for i in range(30):
        w = jax_step_draw(js, st)
        x = ps.candid_x.clone()
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        for f in ("candid_x", "pi_cuts", "sigma_pib", "lambda_vals",
                  "delta_pib", "omega_vals"):
            assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (i, f)
        for f in ("k", "omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt"):
            assert getattr(ps, f) == int(getattr(st, f)), (i, f)
        j_istar = torch.as_tensor(np.asarray(st.cut_istar))
        slots = torch.nonzero(torch.any(ps.cut_istar != j_istar, dim=1))
        if slots.numel() == 0:
            for f in ("cut_alpha", "cut_beta", "candid_est"):
                assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (i, f)
            continue
        # The packages chose different vertices: only in this step's cut.
        assert slots.numel() == 1, i
        s = int(slots[0, 0])
        H, s_valid, o_valid = height_table(pa, ps, x)
        hmax = torch.amax(torch.where(s_valid[:, None], H, -1e300), dim=0)
        cols = torch.arange(H.shape[1])
        for istar in (ps.cut_istar[s], j_istar[s]):
            assert bool(torch.all(s_valid[istar[o_valid]])), i
            assert torch.equal(H[istar, cols][o_valid], hmax[o_valid]), i
        mine = ps.cut_alpha[s] - ps.cut_beta[s] @ x
        theirs = np.asarray(st.cut_alpha)[s] - \
            np.asarray(st.cut_beta)[s] @ x.numpy()
        assert _rel(mine, theirs) <= 1e-12, i
        ties.append(ps.k)
        ps = to_port_state(st)
    assert ties == [17]


@functools.lru_cache(maxsize=None)
def _mip_states(master_type):
    """JAX states of the deterministic intcaplike after 6 and 20 steps."""
    js = JaxSolver(_intcap(False, True),
                   JaxConfig(MASTER_TYPE=master_type, MAX_ITER=60,
                             MIN_ITER=10, EVAL_FLAG=False))
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(0))
    out = {}
    for i in range(1, 21):
        st = js.step(st)
        if i in (6, 20):
            out[i] = jax.tree.map(jnp.copy, st)
    return js, out


@pytest.mark.parametrize("k", [6, 20])
@pytest.mark.parametrize("master_type", [MASTER_MIQP, MASTER_MILP])
def test_mip_master_matches_jax_tree(master_type, k):
    js, states = _mip_states(master_type)
    st = states[k]
    pa = stage_problem(_intcap(True, True), CPU)
    cfg = SDConfig(MASTER_TYPE=master_type, MAX_ITER=60, EVAL_FLAG=False)
    mine = make_mip_master(pa, cfg)(to_port_state(st))
    theirs = jax_make_mip_master(js.pa, js.cfg)(st)
    assert mine.found and theirs.found
    assert mine.nodes == theirs.nodes and mine.waves == theirs.waves
    assert mine.nodes > 1                  # the tree branched
    assert (mine.truncated, mine.uncertified) == \
        (theirs.truncated, theirs.uncertified)
    np.testing.assert_array_equal(mine.x[:2], theirs.x[:2])
    assert _rel(mine.x, theirs.x) <= 1e-9
    assert _rel(mine.obj, theirs.obj) <= 1e-9


def test_miqp_run_lands_on_integer_optimum():
    solver = SDSolver(_intcap(True, True),
                      SDConfig(MASTER_TYPE=MASTER_MIQP, MAX_ITER=60,
                               MIN_ITER=10, EVAL_FLAG=False), device="cpu")
    assert solver.mip_master is not None
    res = solver.solve_replication(0)
    xi = res.incumb_x[:2]
    assert np.allclose(xi, np.round(xi), atol=1e-6), xi
    best, _ = _brute_force([2.4], [1.0])
    got = _true_cost(int(round(xi[0])), int(round(xi[1])), [2.4], [1.0])
    assert abs(got - best) < 1e-9


def test_milp_run_is_integral_to_max_iter():
    solver = SDSolver(_intcap(True, False),
                      SDConfig(MASTER_TYPE=MASTER_MILP, MAX_ITER=80,
                               EVAL_FLAG=False), device="cpu")
    res = solver.solve_replication(0)
    assert res.iterations == 80 and not res.optimal
    xi = res.incumb_x[:2]
    assert np.allclose(xi, np.round(xi), atol=1e-6), xi
    best, _ = _brute_force()
    got = _true_cost(int(round(xi[0])), int(round(xi[1])))
    assert (got - best) / abs(best) < 0.02


@pytest.mark.parametrize("master_type,max_iter,qp",
                         [(MASTER_LP, 60, False), (MASTER_MIQP, 30, True)])
def test_lands_master_types(master_type, max_iter, qp):
    """The LP master runs to MAX_ITER with no statistical stop; MASTER_TYPE
    7 on a problem with no integer column is the QP master."""
    solver = SDSolver(port_problem("lands"),
                      SDConfig(MASTER_TYPE=master_type, MAX_ITER=max_iter,
                               EVAL_FLAG=False), device="cpu")
    assert solver.mip_master is None
    res = solver.solve_replication(0)
    assert res.iterations == max_iter and not res.optimal
    # The QP master forms incumbent cuts too; the LP master only candidates.
    assert (res.cuts_formed > res.iterations) == qp
